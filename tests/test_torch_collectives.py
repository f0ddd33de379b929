"""The collectives ledger (``commefficient_torch/telemetry/
collectives.py``), against the JAX package's ``telemetry/collectives.py``
and its tests (``tests/test_wire.py:430``, ``tests/test_sharded_server.py
:361,398``).

Here: the launch bounds, the wire model and the summary are the JAX
package's (bitwise on the JAX test's entries); the recorder sees each
``Mesh`` launch and nothing outside its block. On 2 and 4 gloo ranks (the
rank groups of ``test_torch_mesh.py`` and ``test_torch_mesh4.py``, which
hold these checks): every mode's round within
``ROUND_COLLECTIVE_LAUNCH_BOUNDS``; the sharded sketch round's counts
equal at W = 8 and W = 16 (a launch a client or a row would show);
the sharded round's reduce-scatter, no table-sized all-reduce, and its
candidate gathers of n k_loc values and indices; int8's table-reduce
wire bytes at most 0.30 of the float32 wire's; the ``collectives``
event in the stream rank 0 writes, passing the port's
``check_telemetry_schema``.
"""

import numpy as np

from commefficient_tpu.telemetry import collectives as jcoll  # noqa: E402

from commefficient_torch.scripts import check_telemetry_schema  # noqa
from commefficient_torch.telemetry import collectives as tcoll  # noqa

ENTRIES = [{"kind": "reduce-scatter", "bytes": 768, "n_elements": 192,
            "combined_in": 0},
           {"kind": "all-to-all", "bytes": 1536, "n_elements": 1536,
            "combined_in": 1},
           {"kind": "all-reduce", "bytes": 100, "n_elements": 25,
            "combined_in": 2},
           {"kind": "all-gather", "bytes": 800, "n_elements": 200,
            "combined_in": 2},
           {"kind": "collective-permute", "bytes": 64, "n_elements": 16,
            "combined_in": 3}]


def test_bounds_and_kinds_are_the_jax_packages():
    assert tcoll.ROUND_COLLECTIVE_LAUNCH_BOUNDS == \
        jcoll.ROUND_COLLECTIVE_LAUNCH_BOUNDS
    assert tcoll.COLLECTIVE_KINDS == jcoll.COLLECTIVE_KINDS


def test_wire_model_and_summary_match_the_jax_package():
    for n in (1, 2, 4, 8):
        for e in ENTRIES:
            assert tcoll.collective_wire_bytes(e, n) == \
                jcoll.collective_wire_bytes(e, n)
        assert tcoll.table_reduce_wire_bytes(ENTRIES, n) == \
            jcoll.table_reduce_wire_bytes(ENTRIES, n)
    assert tcoll.summarize_ledger(ENTRIES) == jcoll.summarize_ledger(ENTRIES)
    # the JAX test's int8 geometry: cells and scales against the f32
    # reduce-scatter of a (3, 512) table on 8 devices
    rs = {"kind": "reduce-scatter", "bytes": 768}
    a2a = [{"kind": "all-to-all", "bytes": 1536},
           {"kind": "all-to-all", "bytes": 96}]
    assert tcoll.table_reduce_wire_bytes(a2a, 8) <= \
        0.30 * tcoll.table_reduce_wire_bytes([rs], 8)


def test_recorder_sees_only_its_block():
    from commefficient_torch.parallel.mesh import _note
    import torch
    x = torch.zeros(3)
    _note("all-gather", "all_gather_into_tensor", x)      # not recording
    with tcoll.recording() as outer:
        _note("all-reduce", "all_reduce", x)
        with tcoll.recording() as inner:
            _note("all-to-all", "all_to_all_single",
                  torch.zeros(4, dtype=torch.int8))
        _note("all-gather", "all_gather_into_tensor",
              torch.zeros(2, dtype=torch.bfloat16))
    assert [e["kind"] for e in outer] == ["all-reduce", "all-gather"]
    assert [(e["dtype"], e["bytes"]) for e in outer] == [("f32", 12),
                                                         ("bf16", 4)]
    assert inner == [{"kind": "all-to-all", "via": "all_to_all_single",
                      "n_elements": 4, "dtype": "s8", "bytes": 4,
                      "combined_in": 0}]
    assert tcoll.past_bounds(outer) == {}
    many = [dict(outer[0], combined_in=i) for i in range(13)]
    assert tcoll.past_bounds(many) == {"all-reduce": 13}


# -------------------------------------------------- the rank groups


def check_bounds(res):
    for r in res:
        for name, led in r["a9b"]["ledger"].items():
            assert led, name
            assert tcoll.past_bounds(led) == {}, (name,
                                                    tcoll.summarize_ledger(
                                                        led)["counts"])
            assert {e["kind"] for e in led} <= set(tcoll.COLLECTIVE_KINDS)


def check_w8_w16(res):
    for r in res:
        led = r["a9b"]["ledger"]
        assert tcoll.summarize_ledger(led["sketch"])["counts"] == \
            tcoll.summarize_ledger(led["sketch_w16"])["counts"]


def check_sharded_kinds(res, r_rows=3, c=512):
    n = len(res)
    for r in res:
        led = r["a9b"]["ledger"]["sketch"]
        counts = tcoll.summarize_ledger(led)["counts"]
        assert counts.get("reduce-scatter", 0) >= 1, counts
        big = [e for e in led if e["kind"] == "all-reduce"
               and e["n_elements"] >= r_rows * c]
        assert not big, big
        k_loc = r["a9b"]["k_loc"]
        # the candidates: the indices' gather of n k_loc integers and the
        # values' gather just before it, n k_loc candidates of 8 to 12
        # bytes (float32 values, int32 or int64 indices)
        idx = [i for i, e in enumerate(led) if e["kind"] == "all-gather"
               and e["n_elements"] == n * k_loc and e["dtype"][0] == "s"]
        assert len(idx) == 1 and idx[0] > 0
        vals = led[idx[0] - 1]
        assert (vals["kind"], vals["dtype"], vals["n_elements"]) == (
            "all-gather", "f32", n * k_loc)
        got = vals["bytes"] + led[idx[0]]["bytes"]
        assert n * k_loc * 8 <= got <= n * k_loc * 12
        # the replicated tail all-reduces the table instead
        rep = r["a9b"]["ledger"]["sketch_replicated"]
        assert [e for e in rep if e["kind"] == "all-reduce"
                and e["n_elements"] == r_rows * c]


def check_int8_bytes(res):
    n = len(res)
    for r in res:
        led = r["a9b"]["ledger"]
        f32 = tcoll.table_reduce_wire_bytes(led["sketch"], n)
        i8 = tcoll.table_reduce_wire_bytes(led["sketch_int8"], n)
        assert f32 > 0 and i8 <= 0.30 * f32, (i8, f32)


def check_event(res):
    path = res[0]["a9b"]["stream"]
    assert check_telemetry_schema.main([path]) == 0
    import json
    evs = [json.loads(ln) for ln in open(path)]
    ev = [e for e in evs if e["event"] == "collectives"]
    assert len(ev) == 1 and ev[0]["wire_dtype"] == "int8"
    n = len(res)
    assert ev[0]["table_reduce_bytes"] == tcoll.table_reduce_wire_bytes(
        res[0]["a9b"]["ledger"]["sketch_int8"], n)
    assert ev[0]["counts"] == tcoll.summarize_ledger(
        res[0]["a9b"]["ledger"]["sketch_int8"])["counts"]
    assert np.isfinite(ev[0]["total_bytes"])
