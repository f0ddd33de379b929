"""The packed PersonaChat cache and the iid splits of the PyTorch port
against the JAX package, on the CPU (synthetic dialogues).

Both packages write and read the same files under ``dataset_dir``
(``FedPERSONA_persona_train.npz``, ``FedPERSONA_persona_val.npz``, the
prep sidecar ``FedPERSONA_persona_prep.json`` and
``stats_FedPERSONA.json``): a cache written by one is read by the other
without packing again, a changed knob packs again, and the layouts of
earlier JAX package versions are adopted or set aside as the JAX package
does. Packs are counted by wrapping ``_pack_split``. Arrays, splits and
file sets are held bit for bit.
"""

import json
import os

import numpy as np
import pytest

from commefficient_tpu.data import fed_persona as jpersona
from commefficient_torch.data import fed_persona as tpersona

PACKAGES = {"jax": jpersona, "port": tpersona}
KW = dict(max_seq_len=48, synthetic=True)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one intra-op thread in this file: at these sizes more
    threads only spin while the test run's other workers share the
    machine's cores."""
    import torch_mesh_ranks as ranks
    with ranks.one_thread():
        yield


@pytest.fixture
def packs(monkeypatch):
    """Counts ``_pack_split`` calls of either package's FedPERSONA."""
    count = {"jax": 0, "port": 0}
    for name, mod in PACKAGES.items():
        orig = mod.FedPERSONA._pack_split

        def counted(self, *a, _orig=orig, _name=name, **kw):
            count[_name] += 1
            return _orig(self, *a, **kw)

        monkeypatch.setattr(mod.FedPERSONA, "_pack_split", counted)
    return count


def _same(a, b):
    assert len(a) == len(b)
    assert sorted(a.arrays) == sorted(b.arrays)
    for key, arr in b.arrays.items():
        assert a.arrays[key].dtype == arr.dtype
        np.testing.assert_array_equal(a.arrays[key], arr)


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_cache_is_read_across_packages(tmp_path, packs, writer, reader):
    d = str(tmp_path)
    for train in (True, False):
        ref = PACKAGES[writer].FedPERSONA(d, train=train, **KW)
        got = PACKAGES[reader].FedPERSONA(d, train=train, **KW)
        _same(got, ref)
    # the writer packed both splits once (train, then validation)
    assert packs == {writer: 2, reader: 0}
    assert sorted(os.listdir(d)) == [
        "FedPERSONA_persona_prep.json", "FedPERSONA_persona_train.npz",
        "FedPERSONA_persona_val.npz", "stats_FedPERSONA.json"]


@pytest.mark.parametrize("knob,value", [
    ("max_seq_len", 64), ("num_candidates", 1), ("max_history", 0),
    ("personality_permutations", 2)])
def test_changed_knob_packs_again(tmp_path, packs, knob, value):
    """The port's cache, then the port with one knob changed: it packs
    again, and the JAX package then reads the new pack as its own."""
    d = str(tmp_path)
    tpersona.FedPERSONA(d, **KW)
    kw = dict(KW, **{knob: value})
    got = tpersona.FedPERSONA(d, **kw)
    assert packs["port"] == 4
    with open(os.path.join(d, "FedPERSONA_persona_prep.json")) as f:
        assert json.load(f)[knob] == value
    ref = jpersona.FedPERSONA(d, **kw)
    assert packs["jax"] == 0
    _same(got, ref)


def _forge(d, layout, prep_config):
    """An earlier JAX package version's layout of the cache in ``d``:
    ``plain`` (unprefixed pack and a plain stats.json, with a sidecar),
    ``plain_no_sidecar`` (the same without one: packed under other rules)
    or ``mixed`` (prefixed stats, unprefixed pack and sidecar)."""
    for fn in ("persona_train.npz", "persona_val.npz"):
        os.rename(os.path.join(d, f"FedPERSONA_{fn}"), os.path.join(d, fn))
    os.unlink(os.path.join(d, "FedPERSONA_persona_prep.json"))
    if layout != "mixed":
        os.rename(os.path.join(d, "stats_FedPERSONA.json"),
                  os.path.join(d, "stats.json"))
    if layout != "plain_no_sidecar":
        with open(os.path.join(d, "persona_prep.json"), "w") as f:
            json.dump(prep_config, f)


@pytest.mark.parametrize("layout", ["plain", "plain_no_sidecar", "mixed"])
def test_legacy_layouts_as_the_jax_package(tmp_path, packs, layout):
    """Twin directories with the same forged layout, one opened by each
    package: the same items, the same legacy flag, the same packs and the
    same files afterwards (adopted in place, renamed into the prefixed
    names, or packed again with the old files set aside as ``*.stale``)."""
    out = {}
    for name, mod in PACKAGES.items():
        d = str(tmp_path / name)
        base = jpersona.FedPERSONA(d, **KW)
        _forge(d, layout, base._prep_config)
        before = dict(packs)
        ds = mod.FedPERSONA(d, **KW)
        out[name] = (ds, ds._legacy_layout, packs[name] - before[name],
                     sorted(os.listdir(d)))
        _same(ds, base)
    (jds, *jrest), (tds, *trest) = out["jax"], out["port"]
    assert trest == jrest
    _same(tds, jds)
    repacked = {"plain": 0, "plain_no_sidecar": 2, "mixed": 0}[layout]
    assert trest[1] == repacked


@pytest.mark.parametrize("num_clients", [5, 7, 16, 36])
def test_iid_splits_equal_the_jax_package(tmp_path, num_clients):
    """``do_iid``: the same permutation, the same items per client (12
    natural clients, so 5, 7 and 16 are no multiple of them) and the same
    gathered items; the validation split is not permuted. Without
    ``do_iid`` such a count is refused, naming ``--iid``."""
    d = str(tmp_path)
    ref = jpersona.FedPERSONA(d, do_iid=True, num_clients=num_clients, **KW)
    got = tpersona.FedPERSONA(d, do_iid=True, num_clients=num_clients, **KW)
    assert got.num_clients == ref.num_clients == num_clients
    np.testing.assert_array_equal(got.iid_shuffle, ref.iid_shuffle)
    np.testing.assert_array_equal(got.data_per_client, ref.data_per_client)
    assert got.data_per_client.sum() == len(got)
    idx = np.arange(len(got)).reshape(-1, 2)[::-1]
    for key, arr in ref.gather(idx).items():
        np.testing.assert_array_equal(got.gather(idx)[key], arr)
    jval = jpersona.FedPERSONA(d, train=False, **KW)
    tval = tpersona.FedPERSONA(d, train=False, **KW)
    for key, arr in jval.gather(np.arange(3)).items():
        np.testing.assert_array_equal(tval.gather(np.arange(3))[key], arr)
    natural = tpersona.FedPERSONA(d, num_clients=num_clients, **KW)
    if num_clients % 12:
        with pytest.raises(ValueError, match="--iid"):
            natural.data_per_client
    else:
        assert natural.data_per_client.sum() == len(natural)
