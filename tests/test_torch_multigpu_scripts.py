"""The port's multi-GPU scripts, ``commefficient_torch/scripts/
scaling_curves.py`` and ``multihost_dryrun.py`` (the JAX package's
``scripts/scaling_curves.py`` and ``scripts/multihost_dryrun.py``), on
gloo CPU ranks.

- ``scaling_curves --device cpu`` over 1 and 2 ranks, float32 and int8:
  one JSONL line an arm (the weak arms W = 2n, the strong arms W = 8,
  the int8 wire's weak arms), each with its items/s, per-rank items/s,
  collectives within the JAX launch bounds and its table-reduce bytes
  (0 at n = 1, as the wire model says); the int8 arm's reduce two
  all-to-alls and no reduce-scatter; then the int8 wire gate's line
  (at most 0.30 of the float32 bytes) and exit 0. The per-rank gate
  needs two multi-rank weak arms (2 and 4 ranks): under ``slow``, with
  its ``teleview diff`` line, and an impossible drop threshold failing
  it (exit 1);
- ``multihost_dryrun`` under ``slow``: two ``torchrun`` launchers of 4
  ranks against one of 8, its PASS line and exit 0.
"""

import json

import pytest

from commefficient_torch.scripts import multihost_dryrun, scaling_curves
from commefficient_torch.telemetry.collectives import \
    ROUND_COLLECTIVE_LAUNCH_BOUNDS
import torch_mesh_ranks as ranks


def read(path):
    return [json.loads(ln) for ln in open(path)]


def test_scaling_curves_lines_and_int8_gate(tmp_path, capsys):
    out = tmp_path / "scaling.jsonl"
    # torch on one thread here, as in the ranks: more only spin
    with ranks.one_thread():
        rc = scaling_curves.main(["--device", "cpu", "--devices", "1,2",
                                  "--rounds", "1", "--warmup", "1",
                                  "--wire_dtype", "float32,int8",
                                  "--out", str(out)])
    assert rc == 0
    lines = read(out)
    arms = [ln for ln in lines if ln["kind"] == "arm"]
    assert [(a["scaling"], a["wire_dtype"], a["devices"]) for a in arms] \
        == [("weak", "float32", 1), ("weak", "float32", 2),
            ("strong", "float32", 1), ("strong", "float32", 2),
            ("weak", "int8", 1), ("weak", "int8", 2)]
    for a in arms:
        assert a["num_workers"] == (2 * a["devices"] if a["scaling"] ==
                                    "weak" else 8)
        assert a["items_per_s"] > 0 and a["per_chip_items_per_s"] == \
            a["items_per_s"] / a["devices"]
        assert a["backend"] == "gloo-cpu" and a["sharded_server"]
        for kind, count in a["collectives"].items():
            assert count <= ROUND_COLLECTIVE_LAUNCH_BOUNDS[kind]
        if a["devices"] == 1:
            assert a["table_reduce_bytes"] == 0.0
        if a["wire_dtype"] == "int8":
            assert a["collectives"].get("all-to-all") == 2
            assert "reduce-scatter" not in a["collectives"]
        else:
            assert a["collectives"]["reduce-scatter"] == 1
    gates = [ln for ln in lines if ln["kind"] == "gate"]
    assert [g["gate"] for g in gates] == ["wire_bytes_int8"]
    assert gates[0]["passed"] and gates[0]["int8_table_reduce_bytes"] <= \
        0.30 * gates[0]["f32_table_reduce_bytes"]
    assert "int8 wire gate (n=2)" in capsys.readouterr().out


@pytest.mark.slow
def test_scaling_curves_perchip_gate(tmp_path):
    out = tmp_path / "scaling.jsonl"
    assert scaling_curves.main(["--device", "cpu", "--rounds", "2",
                                "--out", str(out)]) == 0
    gate = [ln for ln in read(out) if ln["kind"] == "gate"]
    assert gate[0]["gate"] == "teleview_diff_perchip" and gate[0]["passed"]
    assert scaling_curves.main(["--device", "cpu", "--rounds", "2",
                                "--perchip_drop", "-1", "--out",
                                str(out)]) == 1


@pytest.mark.slow
def test_multihost_dryrun(capsys):
    assert multihost_dryrun.main([]) == 0
    text = capsys.readouterr().out
    assert "multihost dryrun: PASS" in text
    assert "the world spans both launchers: True" in text
