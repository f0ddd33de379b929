"""The port's host-side telemetry (``commefficient_torch/telemetry/
population.py``, ``health.py``, ``clients.py``'s participation ledger,
``core/preempt.py``'s ledger sidecar) against the JAX package's, on the
CPU: the population sketches' state dicts bit for bit equal (as JSON)
on one seeded, skewed id stream; the anomaly monitor firing the same
rules at the same ``seq`` on one synthetic stream; the ledger sidecar
crossing between the packages in both directions; the flight recorder's
bundle through the port's checkpoint layer; and the watchdog's stall as
an alert, a fault event and an events-only bundle."""

import json
import math
import os

import numpy as np
import pytest
import torch

from commefficient_torch.core.driver import Observers
from commefficient_torch.core.preempt import (collect_ledger_state,
                                              restore_ledger_state)
from commefficient_torch.core.state import FedState
from commefficient_torch.telemetry import (AnomalyMonitor, FlightRecorder,
                                           ParticipationLedger,
                                           PopulationLedger, RunTelemetry,
                                           make_ledger, robust_z,
                                           validate_file)
from commefficient_torch.telemetry.population import (CountMinSketch,
                                                      KMVSample, P2Quantile,
                                                      SpaceSaving, mix64)

jpop = pytest.importorskip("commefficient_tpu.telemetry.population")
jclients = pytest.importorskip("commefficient_tpu.telemetry.clients")
jhealth = pytest.importorskip("commefficient_tpu.telemetry.health")
jpreempt = pytest.importorskip("commefficient_tpu.core.preempt")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one intra-op thread in this file: at these sizes more
    threads only spin while the test run's other workers share the
    machine's cores."""
    import torch_mesh_ranks as ranks
    with ranks.one_thread():
        yield


def id_stream(seed=7, rounds=60, slots=24, universe=5000):
    """A zipf head over a uniform tail, per round (ids, samples)."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(rounds):
        hot = rs.zipf(1.5, slots // 2) % universe
        cold = rs.randint(0, universe, slots - slots // 2)
        out.append((np.concatenate([hot, cold]).astype(np.int64),
                    rs.randint(0, 9, slots).astype(np.int64)))
    return out


def drive(ledger, stream):
    for rnd, (ids, n) in enumerate(stream, start=1):
        ledger.observe(rnd, ids, n)
        ledger.observe_loss_argmax(int(ids[0]))
        if rnd % 5 == 0:
            ledger.observe_strikes([int(i) for i in ids[:3]])
    return ledger


@pytest.mark.parametrize("backing", ["sketch", "exact"])
def test_ledger_state_matches_reference_bitwise(backing):
    """One seeded stream through either package's ledger: the state
    dicts (base64 sketches included) and both snapshots are equal as
    JSON, i.e. bit for bit."""
    stream = id_stream()
    if backing == "sketch":
        ours = drive(PopulationLedger(5000, seed=3), stream)
        ref = drive(jpop.PopulationLedger(5000, seed=3), stream)
    else:
        ours = drive(ParticipationLedger(5000), stream)
        ref = drive(jclients.ParticipationLedger(5000), stream)
    assert json.dumps(ours.state_dict()) == json.dumps(ref.state_dict())
    r = len(stream)
    assert json.dumps(ours.snapshot(r)) == json.dumps(ref.snapshot(r))
    assert json.dumps(ours.population_snapshot(r)) == json.dumps(
        ref.population_snapshot(r))


def test_sketch_primitives_match_reference():
    """CountMinSketch, SpaceSaving, P2Quantile, KMVSample and mix64 on
    the same inputs: equal states and answers."""
    rs = np.random.RandomState(11)
    ids = (rs.zipf(1.3, 3000) % 100_000).astype(np.int64)
    w = rs.randint(1, 5, ids.size).astype(np.float64)
    np.testing.assert_array_equal(mix64(ids, 9), jpop.mix64(ids, 9))
    pairs = ((CountMinSketch(seed=4), jpop.CountMinSketch(seed=4), "add"),
             (SpaceSaving(32), jpop.SpaceSaving(32), "offer"))
    for ours, ref, method in pairs:
        for chunk in range(0, ids.size, 500):
            sl = slice(chunk, chunk + 500)
            getattr(ours, method)(ids[sl], w[sl])
            getattr(ref, method)(ids[sl], w[sl])
        assert json.dumps(ours.state_dict()) == json.dumps(ref.state_dict())
    k, kr = KMVSample(256, seed=2), jpop.KMVSample(256, seed=2)
    for rnd, chunk in enumerate(range(0, ids.size, 500), start=1):
        uniq, n = np.unique(ids[chunk: chunk + 500], return_counts=True)
        k.observe(rnd, uniq, n.astype(np.float64))
        kr.observe(rnd, uniq, n.astype(np.float64))
    assert k.distinct() == kr.distinct()
    assert json.dumps(k.state_dict()) == json.dumps(kr.state_dict())
    p, q = P2Quantile(0.9), jpop.P2Quantile(0.9)
    for x in rs.lognormal(size=400):
        p.add(float(x))
        q.add(float(x))
    assert p.value() == q.value()
    assert json.dumps(p.state_dict()) == json.dumps(q.state_dict())


def test_make_ledger_policy_matches_reference():
    for n in (10, 99_999, 100_000):
        for mode in ("auto", "on", "off"):
            assert type(make_ledger(n, mode)).__name__ == type(
                jclients.make_ledger(n, mode)).__name__


def synthetic_stream(n=90, seed=5):
    """Monitored events of a run that degrades: a loss spike, an error
    norm blow-up, a client loss spread, a null precursor, an MFU cliff,
    and population events that stall."""
    rs = np.random.RandomState(seed)
    ev = []
    for i in range(1, n + 1):
        loss = 2.0 + 0.02 * rs.randn() + (30.0 if i == 60 else 0.0)
        ev.append(("round", {"round": i, "loss": loss,
                             "acc": 0.5 + 0.01 * rs.randn()}))
        err = 1.0 + 0.01 * rs.randn() + (50.0 if i >= 70 else 0.0)
        ev.append(("signals", {
            "round": i, "error_norm": err,
            "update_norm": 0.1 + 0.001 * rs.randn(),
            "velocity_norm": 0.2 + 0.002 * rs.randn(),
            "topk_overlap": 0.9 + 0.01 * rs.randn(),
            "grad_norm": None if i == 80 else 1.0 + 0.01 * rs.randn()}))
        spread = 0.2 + 0.01 * rs.randn() + (20.0 if i == 75 else 0.0)
        ev.append(("client_stats", {
            "round": i, "quantiles": {
                "loss": {"p5": 1.0, "p95": 1.0 + spread},
                "tx_norm": {"max": 5.0 + 0.05 * rs.randn()}}}))
        if i % 4 == 0:
            mfu = 0.4 + 0.004 * rs.randn() - (0.35 if i >= 84 else 0.0)
            ev.append(("utilization", {"round": i, "mfu": mfu}))
        ev.append(("population", {
            "round": i, "registered": 1000, "coverage": min(i, 40) / 1000,
            "distinct": float(min(i, 40)),
            "top_sampled": [[1, float(i)], [2, 1.0]]}))
    return ev


def test_monitor_fires_the_same_rules_at_the_same_seq():
    """The same monitored stream into either package's AnomalyMonitor:
    the same alerts, in the same order, at the same event index."""
    fired = {}
    for name, cls in (("ours", AnomalyMonitor),
                      ("ref", jhealth.AnomalyMonitor)):
        mon = cls(None, window=16, action="log")
        out = []
        for seq, (kind, rec) in enumerate(synthetic_stream()):
            for a in mon.observe(kind, dict(rec, seq=seq)):
                out.append((seq, a["rule"], a["metric"], a["severity"],
                            a["zscore"]))
        fired[name] = out
    assert fired["ours"] == fired["ref"]
    assert len({r for _, r, _, _, _ in fired["ours"]}) >= 3


def test_robust_z_is_the_references():
    hist = [0.0] * 10 + [1.0, 2.0, 3.0]
    for v, kw in ((5.0, {}), (1.0, {"mad_floor_abs": 0.5}),
                  (-3.0, {"mad_floor_frac": 0.1})):
        assert robust_z(v, hist, **kw) == jhealth.robust_z(v, hist, **kw)


def filled_ledgers(pkg):
    """A participation ledger and a monitor of ``pkg`` ("ours"/"ref")
    that have seen a few rounds."""
    led_cls = (ParticipationLedger if pkg == "ours"
               else jclients.ParticipationLedger)
    mon_cls = AnomalyMonitor if pkg == "ours" else jhealth.AnomalyMonitor
    led, mon = led_cls(100), mon_cls(None, window=8)
    for rnd, (ids, n) in enumerate(id_stream(rounds=12, universe=100),
                                   start=1):
        led.observe(rnd, ids, n)
    for kind, rec in synthetic_stream(n=20):
        mon.observe(kind, rec)
    return led, mon


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_ledger_sidecar_crosses_between_packages(tmp_path, direction):
    """A sidecar written by one package (participation, monitor, ring)
    restores into the other's fresh objects, and that package writes the
    same sidecar back, as JSON."""
    src = "ref" if direction == "jax_to_port" else "ours"
    dst = "ours" if src == "ref" else "ref"
    led, mon = filled_ledgers(src)
    collect = (collect_ledger_state if src == "ours"
               else jpreempt.collect_ledger_state)
    tel = RunTelemetry(str(tmp_path), "cv_train")
    side = json.loads(json.dumps(collect(participation=led, monitor=mon,
                                         telemetry=tel)))
    tel.close()
    assert set(side) == {"participation", "monitor", "ring"}
    led2 = (ParticipationLedger(100) if dst == "ours"
            else jclients.ParticipationLedger(100))
    mon2 = (AnomalyMonitor(None, window=8) if dst == "ours"
            else jhealth.AnomalyMonitor(None, window=8))
    restore = (restore_ledger_state if dst == "ours"
               else jpreempt.restore_ledger_state)
    restore(side, participation=led2, monitor=mon2)
    back = (collect_ledger_state if dst == "ours"
            else jpreempt.collect_ledger_state)(participation=led2,
                                               monitor=mon2)
    assert json.dumps(back["participation"]) == json.dumps(
        side["participation"])
    assert json.dumps(back["monitor"]) == json.dumps(side["monitor"])


def test_flight_recorder_bundle_through_port_checkpoints(tmp_path):
    """The first alert owns the bundle: state.npz (the port's
    save_postmortem, readable by its load_state), events.jsonl (the
    ring), alert.json and memory.json (the residency snapshots)."""
    from commefficient_torch.checkpoint import load_state
    tel = RunTelemetry(str(tmp_path), "cv_train", device="cpu")
    tel.memory_event("init")
    tel.round_event(rnd=1, epoch=1, lr=0.1, loss=2.0, acc=0.5,
                    n_valid=4.0, download_bytes=None, upload_bytes=None,
                    host_s=0.0, dispatch_s=0.0, device_s=0.0)
    state = FedState(ps_weights=torch.arange(6, dtype=torch.float32),
                     Vvelocity=torch.zeros(6), Verror=torch.zeros(6),
                     step=3, nan_round=torch.tensor(-1, dtype=torch.int32))
    rec = FlightRecorder(str(tmp_path), tel)
    assert rec.record(state, {"rule": "loss_spike", "round": 9}) == rec.path
    for fn in ("state.npz", "state.meta.json", "events.jsonl",
               "alert.json", "memory.json"):
        assert os.path.exists(os.path.join(rec.path, fn)), fn
    restored = load_state(os.path.join(rec.path, "state"))
    np.testing.assert_array_equal(restored.ps_weights.numpy(),
                                  np.arange(6, dtype=np.float32))
    assert json.load(open(os.path.join(rec.path, "alert.json")))[
        "rule"] == "loss_spike"
    tel.close()
    assert validate_file(tel.path) == []


class _RT:
    """What ``Observers`` reads of a runtime."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.device = torch.device("cpu")


def test_watchdog_stall_is_an_alert_a_fault_and_a_bundle(tmp_path):
    """The watchdog's callback under a stream: a critical round_stall
    alert through the monitor, a fault event, and (under --alert_action
    checkpoint) an events-only bundle: no state fetch."""
    from commefficient_torch.config import FedConfig
    cfg = FedConfig(alert_action="checkpoint", error_type="virtual",
                    local_momentum=0.0)
    tel = RunTelemetry(str(tmp_path), "cv_train", cfg=cfg, device="cpu")
    obs = Observers(_RT(cfg), tel, num_clients=10)
    try:
        obs.stall(7, 12.5, 3.0, "round 7 exceeded its stall deadline")
    finally:
        obs.close()
    tel.close()
    events = [json.loads(line) for line in open(tel.path)]
    alerts = [e for e in events if e["event"] == "alert"]
    faults = [e for e in events if e["event"] == "fault"]
    assert [(a["rule"], a["severity"], a["round"]) for a in alerts] == [
        ("round_stall", "critical", 7)]
    assert [(f["kind"], f["round"]) for f in faults] == [("round_stall", 7)]
    bundle = os.path.join(str(tmp_path), "postmortem")
    assert os.path.exists(os.path.join(bundle, "alert.json"))
    assert not os.path.exists(os.path.join(bundle, "state.npz"))
    assert math.isclose(json.load(open(os.path.join(
        bundle, "alert.json")))["elapsed_s"], 12.5)
    assert validate_file(tel.path) == []
