"""The rank bodies of the port's mesh tests (``test_torch_mesh*.py``,
``test_torch_sharded_server*.py``, ``test_torch_decode_overlap.py``,
``test_torch_seq.py``, and the int8, ledger and sharded-checkpoint cases
of ``test_torch_int8_mesh.py``, ``test_torch_collectives.py`` and
``test_torch_checkpoint_sharded.py``). Each runs in the processes of
``commefficient_torch.parallel.spawn_ranks`` (one gloo rank each), so it
imports torch and the port only; the JAX references are computed in the
test process. Inputs arrive as numpy arrays, results leave as numpy
arrays."""

import contextlib

import numpy as np
import torch

from commefficient_torch.config import FedConfig
from commefficient_torch.core.pipeline import DecodeOverlapRound
from commefficient_torch.core.runtime import FedRuntime
from commefficient_torch.parallel import make_mesh

# the toy of the JAX package's tests/test_parallel.py: a (6, 3) linear
# map, squared error summed over the outputs
D_IN, D_OUT = 6, 3


def quad_loss(flat, batch, mask):
    pred = batch["x"] @ flat.view(D_IN, D_OUT)
    err = ((pred - batch["y"]) ** 2).sum(dim=-1)
    m = mask.to(torch.float32)
    loss = (err * m).sum() / torch.clamp(m.sum(), min=1.0)
    return loss, (loss,)


# the toy of tests/test_sharded_server.py: a (24, 10) softmax classifier
SS_D, SS_C = 24, 10


def nll_loss(flat, batch, mask):
    logits = batch["x"] @ flat.view(SS_D, SS_C)
    lp = torch.log_softmax(logits, dim=-1)
    nll = -lp.gather(-1, batch["target"][..., None])[..., 0]
    m = mask.to(torch.float32)
    loss = (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
    return loss, (loss,)


class Flat:
    """A port model of one flat parameter vector."""

    def __init__(self, flat):
        self.flat = torch.tensor(np.asarray(flat, np.float32).reshape(-1))
        self.num_params = self.flat.numel()


def quad_cfg(**kw) -> FedConfig:
    base = dict(mode="uncompressed", error_type="none", local_momentum=0.0,
                virtual_momentum=0.9, weight_decay=0.0, num_workers=8,
                local_batch_size=4, track_bytes=True, num_clients=16,
                telemetry=False)
    base.update(kw)
    return FedConfig(**base)


def sketch_cfg(**kw) -> FedConfig:
    base = dict(mode="sketch", error_type="virtual", local_momentum=0.0,
                virtual_momentum=0.9, weight_decay=0.0, num_workers=8,
                local_batch_size=4, k=8, num_rows=3, num_cols=64,
                num_blocks=2, num_clients=16, track_bytes=True,
                telemetry=False)
    base.update(kw)
    return FedConfig(**base)


def run_rounds(cfg, params, loss_fn, rounds, mesh=None, lr=0.1,
               split=False):
    """``rounds``: [(ids, batch, mask)]. Returns the flat weights, the
    (n_rounds, W) losses, the last round's download bytes and the
    runtime; ``split`` runs ``DecodeOverlapRound``."""
    rt = FedRuntime(cfg, Flat(params), loss_fn, device="cpu", mesh=mesh)
    obj = DecodeOverlapRound(rt) if split else rt
    st = obj.init_state()
    losses, m = [], None
    for ids, batch, mask in rounds:
        st, m = obj.round(st, ids, batch, mask, lr)
        losses.append(m["results"][0].numpy().copy())
    out = {"weights": rt.flat_weights(st).numpy().copy(),
           "losses": np.stack(losses),
           "download": (m["download_bytes"].numpy().copy()
                        if m["download_bytes"] is not None else None)}
    return out, rt, st


@contextlib.contextmanager
def one_thread():
    """Torch on one thread in this process for the block (a test's
    reference run beside its rank group), then as it was."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def group_body(rank, n, parts):
    """Several bodies in one rank group (one spawn a file): ``parts`` maps
    a name to ``(body, args)``; returns {name: body(rank, n, *args)}."""
    return {name: body(rank, n, *args)
            for name, (body, args) in parts.items()}


# ------------------------------------------------ test_torch_mesh.py


def modes_body(rank, n, cases, params, rounds, val_sets):
    mesh = make_mesh((n,), ("clients",))
    out = {"cases": []}
    for kw in cases:
        res, rt, st = run_rounds(quad_cfg(**kw), params, quad_loss, rounds,
                                 mesh)
        # the whole padded weights: the padding must stay exactly 0
        res["ps_padded"] = mesh.gather_rows(st.ps_weights).numpy()
        res["d_pad"] = rt.d_pad
        out["cases"].append(res)
    # the vector rate on a mesh (:355, :376)
    out["vector_lr"] = {}
    for name, kw in (("fedavg", dict(mode="fedavg", local_batch_size=-1,
                                     max_client_batch=4,
                                     fedavg_batch_size=2,
                                     num_fedavg_epochs=1)),
                     ("sketch", dict(mode="sketch", error_type="virtual",
                                     k=5, num_rows=3, num_cols=32,
                                     num_blocks=2))):
        cfg = quad_cfg(**kw)
        rt = FedRuntime(cfg, Flat(params), quad_loss, device="cpu",
                        mesh=mesh)
        ids, batch, mask = rounds[0]
        lr_vec = np.full(rt.cfg.grad_size, 0.05, np.float32)
        s_vec, _ = rt.round(rt.init_state(), ids, batch, mask, lr_vec)
        s_ref, _ = rt.round(rt.init_state(), ids, batch, mask, 0.05)
        out["vector_lr"][name] = (rt.flat_weights(s_vec).numpy(),
                                  rt.flat_weights(s_ref).numpy(),
                                  rt.d_pad != rt.cfg.grad_size)
    if val_sets is None:
        return out
    # the layout (tests/test_parallel.py:99)
    rt = FedRuntime(quad_cfg(mode="local_topk", error_type="local", k=4,
                             local_momentum=0.9, num_clients=10),
                    Flat(np.zeros(D_IN * D_OUT)), quad_loss, device="cpu",
                    mesh=mesh)
    st = rt.init_state()
    out["layout"] = {
        "num_clients": rt.num_clients, "d_pad": rt.d_pad,
        "shard_of": rt.shard_of, "shapes": rt.state_shapes(),
        "held": {k: tuple(getattr(st, k).shape)
                 for k in ("ps_weights", "Vvelocity", "Verror",
                           "coord_last_update", "client_errors")}}
    # sharded validation (:321)
    rt = FedRuntime(quad_cfg(), Flat(params), quad_loss, device="cpu",
                    mesh=mesh)
    st = rt.init_state()
    out["val"] = []
    for batch, mask in val_sets:
        (loss, acc), cnt = rt.val(st, batch, mask)
        out["val"].append((float(loss), float(acc), float(cnt)))
    # the defaults (:346)
    auto = make_mesh((), ("clients",))
    try:
        make_mesh((2 * n,), ("clients",))
        too_big = None
    except ValueError as err:
        too_big = str(err)
    out["defaults"] = (auto.size, auto.rank, too_big)
    # normclip on a mesh, against the trim refusal
    cfg = quad_cfg(defense="normclip", adversary="scale",
                   adversary_frac=0.25, telemetry=True)
    res, rt, st = run_rounds(cfg, params, quad_loss, rounds, mesh)
    out["normclip"] = res
    try:
        FedRuntime(quad_cfg(defense="trim"), Flat(params), quad_loss,
                   device="cpu", mesh=mesh)
        out["trim"] = None
    except ValueError as err:
        out["trim"] = str(err)
    # telemetry on: the signals of a mesh round read gathered vectors
    out["signals"] = {}
    for name, kw in (("uncompressed", {}),
                     ("sketch", dict(mode="sketch", error_type="virtual",
                                     k=5, num_rows=3, num_cols=32))):
        rt = FedRuntime(quad_cfg(telemetry=True, **kw), Flat(params),
                        quad_loss, device="cpu", mesh=mesh)
        st = rt.init_state()
        for ids, batch, mask in rounds:
            st, m = rt.round(st, ids, batch, mask, 0.1)
        out["signals"][name] = {k: (None if v is None else float(v))
                                for k, v in m["signals"].items()}
    return out


# ------------------------- test_torch_mesh_entry.py, test_torch_mesh_gpt2.py


def cv_result(cv) -> dict:
    """What the entry-point tests compare of a ``cv_train.main`` run."""
    rt = cv["runtime"]
    return {"losses": np.asarray(cv["losses"], np.float64),
            "weights": rt.flat_weights(cv["state"]).numpy(),
            "val": (cv["val_loss"], cv["val_acc"]),
            "bytes": (cv["total_download_mib"], cv["total_upload_mib"]),
            "sharded": rt.sharded_server,
            "n": rt.mesh.size if rt.mesh is not None else 1}


def cv_entry_body(rank, n, cv_argv, resume_argv):
    from commefficient_torch import cv_train
    return {"cv": cv_result(cv_train.main(cv_argv)),
            "cv_resumed": cv_result(cv_train.main(resume_argv))}


def gpt2_result(g) -> dict:
    """What the GPT-2 entry-point test compares of a ``gpt2_train.main``
    run."""
    return {"losses": np.asarray(g["losses"], np.float64),
            "weights": g["runtime"].flat_weights(g["state"]).numpy(),
            "val": (g["val_loss"], g["val_acc"])}


def gpt2_entry_body(rank, n, argv):
    from commefficient_torch import gpt2_train
    return gpt2_result(gpt2_train.main(argv))


# -------------------- test_torch_sharded_server.py (in the mesh groups)


def sharded_body(rank, n, variants, params, rounds, lr_vec):
    mesh = make_mesh((n,), ("clients",))
    out = {"variants": []}
    for kw in variants:
        res_s, rt_s, _ = run_rounds(sketch_cfg(**kw), params, nll_loss,
                                    rounds, mesh)
        res_r, rt_r, _ = run_rounds(
            sketch_cfg(sketch_sharded_server="off", **kw), params,
            nll_loss, rounds, mesh)
        out["variants"].append((res_s, res_r, rt_s.sharded_server,
                                rt_r.sharded_server))
    out["lr_vec"] = []
    for ss in ("auto", "off"):
        res, rt, _ = run_rounds(sketch_cfg(sketch_sharded_server=ss),
                                params, nll_loss, rounds[:3], mesh,
                                lr=lr_vec)
        out["lr_vec"].append(res["weights"])
    try:
        FedRuntime(sketch_cfg(sketch_sharded_server="on", num_cols=61,
                              exact_num_cols=True),
                   Flat(params), nll_loss, device="cpu", mesh=mesh)
        out["on_cols"] = None
    except ValueError as err:
        out["on_cols"] = str(err)
    rt = FedRuntime(sketch_cfg(num_cols=61, exact_num_cols=True),
                    Flat(params), nll_loss, device="cpu", mesh=mesh)
    out["auto_fallback"] = rt.sharded_server
    return out


# ---------------------- test_torch_decode_overlap.py (in the mesh group)


def overlap_body(rank, n, params, rounds):
    mesh = make_mesh((n,), ("clients",))
    out = {}
    mono, _, _ = run_rounds(sketch_cfg(), params, nll_loss, rounds, mesh)
    split, rt, _ = run_rounds(sketch_cfg(decode_overlap=True), params,
                              nll_loss, rounds, mesh, split=True)
    out["reduce_in_decode"] = (mono, split, rt._reduce_in_decode)
    # the cohort's mesh form: one cohort merged first and committed at
    # once is the synchronous round
    rt = FedRuntime(sketch_cfg(async_agg=True, buffer_goal=1,
                               max_inflight=1), Flat(params), nll_loss,
                    device="cpu", mesh=mesh)
    st, losses = rt.init_state(), []
    for ids, batch, mask in rounds:
        st, pay = rt.cohort(st, ids, batch, mask, 0.1)
        st = rt.merge_first(st, pay["sum"], pay["n_total"])
        st, _ = rt.commit(st, 0.1)
        losses.append(pay["results"][0].numpy().copy())
    out["async"] = (mono, {"weights": rt.flat_weights(st).numpy(),
                           "losses": np.stack(losses)})
    return out


# ------------------------------------------------ test_torch_seq.py


def ring_cases(mesh, shapes):
    """Ring attention on this rank's shard of each (B, S, H, D) case of
    ``shapes``, against dense causal attention on the whole sequence:
    the max abs error of the output and of dq, dk, dv (the rank's
    shards)."""
    from commefficient_torch.models.gpt2 import dense_causal_attention
    from commefficient_torch.parallel.ring import ring_attention_inner
    n, i = mesh.size, mesh.rank
    out = []
    for B, S, H, D in shapes:
        rng = np.random.RandomState(0)
        q, k, v, do = (torch.tensor(rng.randn(B, S, H, D), dtype=torch.float32)
                       for _ in range(4))
        full = [t.clone().requires_grad_() for t in (q, k, v)]
        ref = dense_causal_attention(*full)
        g_ref = torch.autograd.grad(ref, full, do)
        loc = [t.chunk(n, 1)[i].clone().requires_grad_() for t in (q, k, v)]
        got = ring_attention_inner(*loc, mesh)
        g_got = torch.autograd.grad(got, loc, do.chunk(n, 1)[i])
        errs = [float((got - ref.chunk(n, 1)[i]).abs().max())]
        errs += [float((a - b.chunk(n, 1)[i]).abs().max())
                 for a, b in zip(g_got, g_ref)]
        out.append(errs)
    return out


def ring_body(rank, n, shapes):
    """The ring over all n ranks as one seq axis."""
    return ring_cases(make_mesh((1, n), ("clients", "seq")).seq, shapes)


GPT2_W, GPT2_B, GPT2_C = 2, 2, 2


def gpt2_seq_runtime(mesh, flat, mode, extra):
    """The JAX seq test's runtime (tests/test_seqparallel.py:38-66) in the
    port: GPT2Config.small in float32, 128 positions, the JAX weights
    ``flat``; seq-sharded on ``mesh`` (dense without one)."""
    from commefficient_torch.gpt2_train import PERSONA_SEQ_SPEC
    from commefficient_torch.losses import make_gpt2_train_loss
    from commefficient_torch.models.gpt2 import GPT2DoubleHeads
    gcfg = gpt2_small()
    model = GPT2DoubleHeads(gcfg)
    with torch.no_grad():
        model.flat.copy_(torch.as_tensor(flat))
    seq = mesh.seq if mesh is not None else None
    tm = GPT2DoubleHeads(gcfg, seq_axis=seq) if seq is not None else model
    cfg = FedConfig(mode=mode, local_momentum=0.0, virtual_momentum=0.9,
                    weight_decay=0.01, num_workers=GPT2_W,
                    local_batch_size=GPT2_B, num_clients=4,
                    track_bytes=False, telemetry=False,
                    error_type=("virtual" if mode in ("sketch", "true_topk")
                                else "none"), **extra)
    return FedRuntime(cfg, model, make_gpt2_train_loss(tm), device="cpu",
                      mesh=mesh,
                      seq_spec=PERSONA_SEQ_SPEC if seq is not None else None)


def gpt2_seq_rounds(mesh, flat, mode, extra, batches):
    rt = gpt2_seq_runtime(mesh, flat, mode, extra)
    st, res = rt.init_state(), []
    mask = np.ones((GPT2_W, GPT2_B), bool)
    for b in batches:
        st, m = rt.round(st, np.arange(GPT2_W), b, mask, 0.05)
        res.append((m["results"][0].numpy().copy(),
                    m["results"][1].numpy().copy()))
    return {"results": res, "weights": rt.flat_weights(st).numpy()}


def gpt2_small():
    from commefficient_torch.models.gpt2 import GPT2Config
    return GPT2Config.small(compute_dtype=torch.float32, n_positions=128)


def seq_grad_check(mesh, flat, batch):
    """Client 0's loss gradient from its seq shards (each rank's partial
    of its own tokens, summed over the seq axis) against the dense
    model's on the whole sequence: (max abs difference, max abs dense
    gradient, the seq loss, the dense loss)."""
    from commefficient_torch.losses import make_gpt2_train_loss
    from commefficient_torch.models.gpt2 import GPT2DoubleHeads
    seq = mesh.seq
    s, n = seq.rank, seq.size
    one = {k: torch.as_tensor(v[0]).long() for k, v in batch.items()}
    local = {k: (v[..., s * (v.shape[-1] // n):(s + 1) * (v.shape[-1] // n)]
                 if v.ndim == 3 else v) for k, v in one.items()}
    mask = torch.ones(GPT2_B, dtype=torch.bool)
    w = torch.as_tensor(flat).clone().requires_grad_()
    seq_loss, _ = make_gpt2_train_loss(
        GPT2DoubleHeads(gpt2_small(), seq_axis=seq))(w, local, mask)
    g = seq.all_reduce(torch.autograd.grad(seq_loss, w)[0])
    w2 = torch.as_tensor(flat).clone().requires_grad_()
    d_loss, _ = make_gpt2_train_loss(GPT2DoubleHeads(gpt2_small()))(
        w2, one, mask)
    g_ref = torch.autograd.grad(d_loss, w2)[0]
    return (float((g - g_ref).abs().max()), float(g_ref.abs().max()),
            float(seq_loss), float(d_loss))


def seq_body(rank, n, flat, cases, batches, boundary, ring_shapes):
    """The seq-sharded GPT-2 rounds on a (2, 2) mesh in each mode of
    ``cases``, the shard-boundary MC case, a one-step gradient check, and
    the ring over 4 ranks."""
    mesh = make_mesh((2, 2), ("clients", "seq"))
    out = {"rounds": [gpt2_seq_rounds(mesh, flat, m, e, batches)
                      for m, e in cases],
           "boundary": gpt2_seq_rounds(mesh, flat, "uncompressed", {},
                                       [boundary]),
           "grad": seq_grad_check(mesh, flat, batches[0]),
           "layout": (mesh.shape, mesh.clients.rank, mesh.seq.rank,
                      mesh.clients.size, mesh.seq.size)}
    # the JAX refusals a seq axis brings to the sketch tail and its wire
    out["refusals"] = []
    for kw in (dict(sketch_sharded_server="on"), dict(wire_dtype="int8")):
        try:
            gpt2_seq_runtime(mesh, flat, "sketch",
                             dict(k=20, num_rows=3, num_cols=64, **kw))
            out["refusals"].append(None)
        except ValueError as err:
            out["refusals"].append(str(err))
    out["ring"] = ring_body(rank, n, ring_shapes)
    return out


# ------- test_torch_int8_mesh.py, test_torch_collectives.py and
# test_torch_checkpoint_sharded.py (in the mesh groups)

INT8_KW = dict(wire_dtype="int8", wire_block=8)
# the ledger's sketch table: (3, 512)
LEDGER_COLS = 512


def ledger_of(rt, rnd):
    """One round of ``rt`` from a fresh state under the collectives
    ledger."""
    from commefficient_torch.telemetry.collectives import round_ledger
    ids, batch, mask = rnd
    return round_ledger(rt, rt.init_state(), ids, batch, mask)[2]


def held_arrays(rt, state):
    """This rank's fields as numpy, and what slice of the whole each is."""
    out = {}
    for name, kind in rt.shard_of.items():
        val = getattr(state, name)
        if val is None:
            continue
        out[name] = (kind, np.asarray(val, np.int32) if name == "step"
                     else val.cpu().numpy())
    return out


def wait_for(path: str, timeout_s: float = 150.0) -> None:
    """Until ``path`` exists (a file the test process writes while the
    ranks run)."""
    import os
    import time
    t0 = time.perf_counter()
    while not os.path.exists(path):
        if time.perf_counter() - t0 > timeout_s:
            raise TimeoutError(f"{path} did not appear")
        time.sleep(0.2)


def a9b_body(rank, n, quad_params, quad_rounds, ss_params, ss_rounds,
             partials, ckpt_dir, jax_ckpt):
    """The A9b cases of an n-rank clients mesh: the int8 reduce and rounds,
    the ledger, the sharded checkpoint."""
    from commefficient_torch.checkpoint import (load_meta, load_state,
                                                restore_own_shards,
                                                save_sharded)
    from commefficient_torch.ops.wire import (REDUCE_SALT,
                                              int8_reduce_scatter,
                                              quantize_table)
    from commefficient_torch.telemetry.collectives import recording
    from commefficient_torch.telemetry.run import RunTelemetry
    mesh = make_mesh((n,), ("clients",))
    out = {}
    # the int8 reduce on the same partial tables as the JAX package's
    part = torch.as_tensor(partials[rank])
    q, s = quantize_table(part, 8, seed=21, round_idx=5,
                          salt=REDUCE_SALT + rank)
    with recording() as led:
        red = int8_reduce_scatter(part, mesh, 8, seed=21, round_idx=5)
    out["int8_reduce"] = (q.numpy(), s.numpy(), red.numpy(), led)
    # the int8 round, monolithic and split, and its refusal off the
    # sharded tail
    mono, rt, _ = run_rounds(sketch_cfg(**INT8_KW), ss_params, nll_loss,
                             ss_rounds, mesh)
    split, rt_s, _ = run_rounds(sketch_cfg(decode_overlap=True, **INT8_KW),
                                ss_params, nll_loss, ss_rounds, mesh,
                                split=True)
    out["int8_rounds"] = (mono, split, rt.sharded_server,
                          rt_s._reduce_in_decode, rt._wire_block)
    try:
        FedRuntime(sketch_cfg(sketch_sharded_server="off", **INT8_KW),
                   Flat(ss_params), nll_loss, device="cpu", mesh=mesh)
        out["int8_refusal"] = None
    except ValueError as err:
        out["int8_refusal"] = str(err)
    # the ledger: every mode's round, the sharded sketch round at W = 8
    # and W = 16, the f32 and int8 table reduce
    led = {}
    for kw in ([dict(mode="uncompressed"),
                dict(mode="true_topk", error_type="virtual", k=5),
                dict(mode="local_topk", error_type="local", k=5,
                     local_momentum=0.9),
                dict(mode="fedavg", local_batch_size=-1, max_client_batch=4,
                     fedavg_batch_size=2, num_fedavg_epochs=1)]):
        rt = FedRuntime(quad_cfg(**kw), Flat(quad_params), quad_loss,
                        device="cpu", mesh=mesh)
        led[kw["mode"]] = ledger_of(rt, quad_rounds[0])
    # the JAX wire gate's table, (3, 512), at the default wire block
    for name, kw in (("sketch", {}), ("sketch_int8", {"wire_dtype": "int8"}),
                     ("sketch_replicated",
                      {"sketch_sharded_server": "off"})):
        rt = FedRuntime(sketch_cfg(num_cols=LEDGER_COLS, **kw),
                        Flat(ss_params), nll_loss, device="cpu", mesh=mesh)
        led[name] = ledger_of(rt, ss_rounds[0])
    ids, batch, mask = ss_rounds[0]
    wide = (np.arange(16), {k: np.concatenate([v, v]) for k, v in
                            batch.items()}, np.concatenate([mask, mask]))
    rt = FedRuntime(sketch_cfg(num_workers=16, num_clients=32,
                               num_cols=LEDGER_COLS),
                    Flat(ss_params), nll_loss, device="cpu", mesh=mesh)
    led["sketch_w16"] = ledger_of(rt, wide)
    out["ledger"] = led
    out["k_loc"] = min(8, rt.d_pad // n)
    # the collectives event, written by rank 0 as the driver writes it
    if rank == 0:
        tel = RunTelemetry(ckpt_dir + f"/tel{n}", "cv_train",
                           cfg=rt.cfg.replace(mesh_shape=(n,),
                                              wire_dtype="int8"))
        tel.collectives_event("round_step", led["sketch_int8"])
        tel.close()
        out["stream"] = tel.path
    # the sharded checkpoint: a dense-row state and a sharded-tail state
    # after two rounds, written from the ranks, read back by this layout
    # (each rank its own shards) bitwise
    saved = {}
    for name, cfg, params, loss, rounds in (
            ("rows", quad_cfg(mode="local_topk", error_type="local", k=5,
                              local_momentum=0.9), quad_params, quad_loss,
             quad_rounds[:2]),
            ("tables", sketch_cfg(), ss_params, nll_loss, ss_rounds[:2])):
        _, rt, st = run_rounds(cfg, params, loss, rounds, mesh)
        path = f"{ckpt_dir}/{name}{n}"
        save_sharded(path, st, rt, {"epoch": 1})
        got = restore_own_shards(path, rt, load_meta(path)["digests"])
        same = all(
            (np.array_equal(getattr(got, f).numpy(),
                            getattr(st, f).cpu().numpy())
             if f != "step" else got.step == st.step)
            for f in rt.shard_of if getattr(st, f) is not None)
        saved[name] = (path, held_arrays(rt, st), rt.shard_of, rt.d_pad,
                       rt.num_clients, same)
    out["saved"] = saved
    # a JAX sharded file of 8 virtual devices into this layout (the test
    # process writes it while the ranks run)
    wait_for(jax_ckpt + ".meta.json")
    rt = FedRuntime(quad_cfg(mode="local_topk", error_type="local", k=5,
                             local_momentum=0.9), Flat(quad_params),
                    quad_loss, device="cpu", mesh=mesh)
    whole = load_state(jax_ckpt, "cpu", load_meta(jax_ckpt)["digests"],
                       rt.full_state_shapes())
    mine = rt.shard_state(whole)
    st, _ = rt.round(mine, *quad_rounds[0][:3], 0.1)
    out["jax_restore"] = ({f: (getattr(whole, f).numpy() if f != "step"
                               else whole.step)
                           for f in rt.shard_of
                           if getattr(whole, f) is not None},
                          rt.flat_weights(st).numpy())
    return out


# ------------- test_torch_mesh_entry.py: the lifted refusals' entry runs


def _fire_at(record: int):
    """Make rank 0's anomaly monitor fire a critical alert at its
    ``record``-th round record (under ``--alert_action abort``: its
    verdict to stop the run)."""
    from commefficient_torch.telemetry import health
    observe = health.AnomalyMonitor.observe
    seen = []

    def patched(self, kind, fields):
        out = observe(self, kind, fields)
        if kind == "round":
            seen.append(fields.get("round"))
            if len(seen) == record:
                self._fire(dict(round=fields.get("round"), rule="test_abort",
                                severity="critical", metric="round.loss",
                                value=None, zscore=None, median=None,
                                mad=None, window=0, action=self.action))
        return out

    health.AnomalyMonitor.observe = patched


def lifted_body(rank, n, int8_argvs, abort_argv, drain_argv):
    """The flags this slice lifted on a mesh, through ``cv_train.main``:
    ``--wire_dtype int8 --checkpoint_sharded`` (an epoch, its sharded
    checkpoint, ``--resume`` to the next, and the same two epochs
    straight), ``--alert_action abort`` (rank 0's monitor fires at its
    second round record) and the preemption drain (SIGTERM to rank 1
    alone, before round 3)."""
    from commefficient_torch import cv_train
    from commefficient_torch.faults import set_fault
    out = {}
    first, resumed, straight = int8_argvs
    out["int8"] = [cv_result(cv_train.main(a))
                   for a in (first, resumed, straight)]
    _fire_at(2)
    res = cv_train.main(abort_argv)
    out["abort"] = (len(res["round_s"]), res["summary"] is None)
    set_fault("sigterm:pre_round:3" if rank == 1 else None)
    try:
        res = cv_train.main(drain_argv)
    finally:
        set_fault(None)
    out["drain"] = (len(res["round_s"]), res["preempted"],
                    res["summary"] is None)
    return out


def gpt2_seq_entry_body(rank, n, argv):
    """``gpt2_train`` on a (1, n) mesh: the clients on every rank, each
    sequence over the n ranks; rank 0's printed lines."""
    import contextlib
    import io
    from commefficient_torch import gpt2_train
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        g = gpt2_train.main(argv)
    out = gpt2_result(g)
    out["seq"] = g["runtime"].seq.size
    out["text"] = text.getvalue()
    return out
