"""The rank bodies of the port's mesh tests (``test_torch_mesh*.py``,
``test_torch_sharded_server*.py``, ``test_torch_decode_overlap.py``). Each runs in the processes of
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
