"""The learning-curve recipes run by both packages from the same weights
and data on the CPU, epoch row by epoch row: the `slow` parity cases of
``test_torch_curves.py`` and a command for the runs too long for a test.

    JAX_PLATFORMS=cpu python tests/torch_curve_parity.py hard_v2|gpt2
        [--epochs 6] [--package both|jax|port] [--seed 21] [--out DIR]
        [--perturb EPS] [--perturb_seed N] [--trace PATH] [--jax_root DIR]
        [--width narrow|full] [--compute_dtype float32|bfloat16]  (hard_v2)
        [--arm ARM] [--load N]                                   (gpt2)

prints each package's first ``--epochs`` epoch rows as JSON, one line an
epoch. ``hard_v2`` runs ``curves.ARMS["cv_uncompressed24"]`` on its
24-epoch schedule, ResNet-9 at full or narrow width, float32 unless
``--compute_dtype``; ``gpt2`` runs a GPT-2 arm of ``curves.ARMS`` with
the narrow ``GPT2DoubleHeads`` in float32 (``--load N``: a sketch arm's
``--num_cols`` cut to ceil(d / N) of the narrow d; the line of a run that
aborted gives its first non-finite round). Both packages start from the
JAX package's initial weights at ``--seed``, carried over by
``params_from_jax``, and prepare their data from the same seed, each in
its own directory under ``--out``. ``--perturb`` scales the initial
weights of each package run by 1 + EPS N(0, 1) (``gpt2``: the JAX
package's too), a control of how far the run moves under a change of
that size; ``--perturb_seed`` draws that change from another seed than
``--seed``'s. ``--trace`` writes each round's clients, rate, mean loss
and the norms (L2, max) of the new weights, error and velocity to
``PATH.<package>.jsonl``. ``--jax_root`` runs the JAX side from
another tree of the JAX package (``git archive COMMIT commefficient_tpu``
unpacked there), less the flags its parser lacks.
"""

import argparse
import contextlib
import importlib.util
import json
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the columns of an epoch row that both packages compute
CV_COLUMNS = ("train_loss", "train_acc", "test_loss", "test_acc")
# the narrow ResNet-9 of the slow case
NARROW = {"prep": 16, "layer1": 32, "layer2": 64, "layer3": 128}


class _Stop(Exception):
    """Raised by a ``Rows`` logger after its last wanted epoch."""


class Rows:
    """A driver logger that keeps each epoch row's ``columns`` and stops
    the run after ``epochs`` rows."""

    def __init__(self, columns, epochs):
        self.columns, self.epochs, self.rows = columns, epochs, []

    def append(self, row):
        self.rows.append([float(row[k]) for k in self.columns])
        if len(self.rows) >= self.epochs:
            raise _Stop


def _run(train, rows):
    try:
        train()
    except _Stop:
        pass
    return rows.rows


def _without_device(argv):
    i = argv.index("--device")
    return argv[:i] + argv[i + 2:]


def hard_v2_argv(out, seed=21, num_epochs=None, dtype="float32"):
    """``cv_uncompressed24``'s argv on the CPU in ``dtype``, its schedule
    ``num_epochs`` long (None: the arm's 24)."""
    from commefficient_torch.scripts import curves
    argv = curves.arm_argv("cv_uncompressed24", seed, out, "cpu")
    if num_epochs is not None:
        argv[argv.index("--num_epochs") + 1] = str(num_epochs)
    return argv + ["--compute_dtype", dtype, "--no_telemetry"]


def jax_params(seed, channels):
    import jax
    import jax.numpy as jnp
    from commefficient_tpu.models import ResNet9 as JResNet9
    jmod = JResNet9(do_batchnorm=True, num_classes=10, channels=channels)
    params = jmod.init(jax.random.PRNGKey(seed), jnp.ones((1, 32, 32, 3)))
    return jmod, params


def _known_to(jconfig, argv):
    """``argv`` less the flags (with their values) that ``jconfig``'s
    parser lacks: an older tree of the JAX package (``--jax_root``) takes
    the recipe's argv without the flags added since."""
    parser = argparse.ArgumentParser()
    jconfig.add_args(parser)
    known = parser._option_string_actions
    keep, i = [], 0
    while i < len(argv):
        if argv[i].startswith("--") and argv[i] not in known:
            print(f"not in this tree's parser, dropped: {argv[i]}",
                  file=sys.stderr)
            i += 1
            if i < len(argv) and not argv[i].startswith("--"):
                i += 1
            continue
        keep.append(argv[i])
        i += 1
    return keep


def hard_v2_jax(argv, epochs, seed=21, channels=None):
    """The JAX package's ``cv_train.train`` on ``argv`` for ``epochs``
    epochs; returns its rows."""
    from commefficient_tpu import config as jconfig
    from commefficient_tpu import cv_train as j_cv
    from commefficient_tpu.core import FedRuntime as JRuntime
    from commefficient_tpu.losses import make_cv_loss as j_make_cv_loss
    jcfg = jconfig.parse_args(_known_to(jconfig, _without_device(argv)),
                              default_lr=0.4)
    jmod, params = jax_params(seed, channels)
    jtrain, jval = j_cv.build_datasets(jcfg)
    jcfg = jcfg.replace(num_clients=jtrain.num_clients)
    jrt = JRuntime(jcfg, params, j_make_cv_loss(jmod, jcfg.compute_dtype),
                   num_clients=jtrain.num_clients)
    rows = Rows(CV_COLUMNS, epochs)
    return _run(lambda: j_cv.train(jcfg, jrt, jrt.init_state(), jtrain,
                                   jval, loggers=(rows,)), rows)


def _perturbed(flat, perturb, seed):
    """Scales each weight of ``flat`` in place by 1 + perturb * N(0, 1)
    (a generator seeded by ``seed``): a control of how far a run moves
    under a change of that size."""
    import torch
    if perturb:
        g = torch.Generator().manual_seed(seed)
        flat.mul_(1 + perturb * torch.randn(flat.shape, generator=g,
                                            dtype=flat.dtype))


def _perturbed_jax(params, perturb, seed):
    """``params`` with each weight scaled by 1 + perturb * N(0, 1) (numpy
    seeded by ``seed``), the JAX side's counterpart of ``_perturbed``."""
    if not perturb:
        return params
    import jax.numpy as jnp
    from jax.flatten_util import ravel_pytree
    flat, unravel = ravel_pytree(params)
    noise = np.random.default_rng(seed).standard_normal(flat.shape)
    return unravel(flat * (1 + perturb * jnp.asarray(noise, flat.dtype)))


def hard_v2_port(argv, epochs, seed=21, channels=None, perturb=0.0):
    """The port's driver on ``argv`` for ``epochs`` epochs, from the JAX
    package's initial weights (``_perturbed`` by ``perturb``); returns
    its rows."""
    import jax
    import torch
    from commefficient_torch import config as tconfig
    from commefficient_torch import cv_train as t_cv
    from commefficient_torch.core import driver
    from commefficient_torch.core.runtime import FedRuntime
    from commefficient_torch.losses import make_cv_loss
    from commefficient_torch.models.convert import params_from_jax
    from commefficient_torch.models.resnet9 import ResNet9
    from commefficient_torch.utils.schedules import lr_schedule_for
    _, params = jax_params(seed, channels)
    tcfg = tconfig.config_from_args(
        tconfig.parse_known(t_cv.build_parser(), argv))
    ttrain, tval = t_cv.build_datasets(tcfg)
    tcfg = tcfg.replace(num_clients=ttrain.num_clients)
    kw = {} if channels is None else {"channels": channels}
    model = ResNet9(do_batchnorm=True, num_classes=10, **kw)
    with torch.no_grad():
        model.flat.copy_(params_from_jax(jax.tree.map(np.asarray, params),
                                         model))
        _perturbed(model.flat, perturb, seed)
    trt = FedRuntime(tcfg, model, make_cv_loss(model, tcfg.compute_dtype),
                     device="cpu")
    stores = t_cv.make_stores(trt, ttrain, tval)
    rows = Rows(CV_COLUMNS, epochs)
    return _run(lambda: driver.train(
        trt, trt.init_state(), ttrain, tval, lr_schedule_for(trt.cfg),
        loggers=(rows,), train_store=stores[0], val_store=stores[1]), rows)


GPT2_COLUMNS = ("train_loss", "test_loss", "test_acc")


# the sketch arms' load d / c at GPT-2's width (92,138,496 / 524,288),
# which the narrow model keeps by a cut of --num_cols (``gpt2_argv``)
GPT2_LOAD = 176


def narrow_gpt2_size():
    """d of the narrow GPT2DoubleHeads over the hash vocabulary."""
    import torch
    from commefficient_torch.data.fed_persona import HashTokenizer
    from commefficient_torch.models import gpt2 as tgpt2
    return tgpt2.GPT2DoubleHeads(tgpt2.GPT2Config.small(
        vocab_size=len(HashTokenizer()) - 5,
        compute_dtype=torch.float32)).flat.numel()


def gpt2_argv(arm, out, seed=21, load=None):
    """``arm``'s argv on the CPU in float32, its corpus under ``out``.
    With ``load``, a sketch arm's --num_cols is cut to ceil(d / load) of
    the narrow model's d, so that the table holds as many coordinates a
    cell as the arm's at full width (its rows, k and every other flag
    unchanged)."""
    from commefficient_torch.scripts import curves
    curves.ensure_corpus(out)
    argv = curves.arm_argv(arm, seed, out, "cpu") + [
        "--compute_dtype", "float32", "--no_telemetry"]
    if load is not None:
        argv[argv.index("--num_cols") + 1] = str(
            -(-narrow_gpt2_size() // load))
    return argv


def with_abort(run, *args, **kw):
    """``run(*args, **kw)``'s epoch rows and the first non-finite round
    of the driver's abort line in what it printed (None: no abort)."""
    import io

    from commefficient_torch.scripts import curves
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rows = run(*args, **kw)
    return rows, curves.abort_round(buf.getvalue())


def jax_gpt2_params(vocab_size, seed):
    """The narrow GPT2DoubleHeads of the slow case (``GPT2Config.small``:
    2 layers, 64 wide, 4 heads) over ``vocab_size`` in float32, and its
    initial weights at ``seed``."""
    import jax
    import jax.numpy as jnp
    from commefficient_tpu.models import gpt2 as jgpt2
    gcfg = jgpt2.GPT2Config.small(vocab_size=vocab_size,
                                  compute_dtype=jnp.float32)
    # dense attention: what "auto" runs below S = 1,024, and a name older
    # trees of the JAX package (``--jax_root``) know too
    jm = jgpt2.GPT2DoubleHeads(gcfg, attn_impl=jgpt2.resolve_attn("dense"))
    ids = jnp.zeros((1, 2, 8), jnp.int32)
    params = jm.init(jax.random.PRNGKey(seed), ids,
                     jnp.zeros((1, 2), jnp.int32), ids)
    return jm, params


def gpt2_jax(argv, epochs, seed=21, perturb=0.0, perturb_seed=None):
    """The JAX package's gpt2_train loop (``cv_train.train`` on
    ``make_gpt2_schedule``) on ``argv`` with the narrow model from its
    initial weights (``_perturbed_jax`` by ``perturb``, drawn from
    ``perturb_seed``, default ``seed``), for ``epochs`` epochs; returns
    its rows."""
    from commefficient_tpu import config as jconfig
    from commefficient_tpu.core import FedRuntime as JRuntime
    from commefficient_tpu.cv_train import train as shared_train
    from commefficient_tpu.data.fed_persona import FedPERSONA, get_tokenizer
    from commefficient_tpu.gpt2_train import make_gpt2_schedule
    from commefficient_tpu.losses import (make_gpt2_train_loss,
                                          make_gpt2_val_loss)
    cfg = jconfig.parse_args(_known_to(jconfig, _without_device(argv)),
                             default_lr=0.16).replace(model="GPT2",
                                                      dataset_name="PERSONA")
    tok = get_tokenizer(cfg.model_checkpoint)
    kw = dict(tokenizer=tok, num_candidates=cfg.num_candidates,
              max_seq_len=cfg.max_seq_len, max_history=cfg.max_history,
              personality_permutations=cfg.personality_permutations)
    train_ds = FedPERSONA(cfg.dataset_dir, train=True, do_iid=cfg.do_iid,
                          num_clients=cfg.num_clients, **kw)
    val_ds = FedPERSONA(cfg.dataset_dir, train=False, **kw)
    cfg = cfg.replace(num_clients=train_ds.num_clients)
    jm, params = jax_gpt2_params(len(tok) - 5, seed)
    params = _perturbed_jax(params, perturb, seed if perturb_seed is None
                            else perturb_seed)
    rt = JRuntime(cfg, params,
                  make_gpt2_train_loss(jm, cfg.lm_coef, cfg.mc_coef,
                                       lm_chunk=cfg.lm_chunk),
                  make_gpt2_val_loss(jm, lm_chunk=cfg.lm_chunk),
                  num_clients=train_ds.num_clients)
    rows = Rows(GPT2_COLUMNS, epochs)
    return _run(lambda: shared_train(
        cfg, rt, rt.init_state(), train_ds, val_ds, loggers=(rows,),
        schedule=make_gpt2_schedule(cfg)), rows)


def gpt2_port_runtime(argv, seed=21, perturb=0.0, perturb_seed=None):
    """The port's runtime on ``argv`` with the narrow model from the JAX
    package's initial weights (``_perturbed`` by ``perturb``, drawn from
    ``perturb_seed``, default ``seed``), and its training and validation
    sets."""
    import jax
    import torch
    from commefficient_torch import config as tconfig
    from commefficient_torch import gpt2_train as t_gpt2
    from commefficient_torch.core.runtime import FedRuntime
    from commefficient_torch.data.fed_persona import FedPERSONA, HashTokenizer
    from commefficient_torch.losses import (make_gpt2_train_loss,
                                            make_gpt2_val_loss)
    from commefficient_torch.models import gpt2 as tgpt2
    from commefficient_torch.models.convert import params_from_jax
    cfg = tconfig.config_from_args(
        tconfig.parse_known(t_gpt2.build_parser(), argv))
    tok = HashTokenizer()
    kw = dict(tokenizer=tok, num_candidates=cfg.num_candidates,
              max_seq_len=cfg.max_seq_len, max_history=cfg.max_history,
              personality_permutations=cfg.personality_permutations)
    train_ds = FedPERSONA(cfg.dataset_dir, train=True, do_iid=cfg.do_iid,
                          num_clients=cfg.num_clients, **kw)
    val_ds = FedPERSONA(cfg.dataset_dir, train=False, **kw)
    cfg = cfg.replace(num_clients=train_ds.num_clients)
    _, params = jax_gpt2_params(len(tok) - 5, seed)
    model = tgpt2.GPT2DoubleHeads(
        tgpt2.GPT2Config.small(vocab_size=len(tok) - 5,
                               compute_dtype=torch.float32),
        attn_impl=cfg.attn_impl)
    with torch.no_grad():
        model.flat.copy_(params_from_jax(jax.tree.map(np.asarray, params),
                                         model))
        _perturbed(model.flat, perturb,
                   seed if perturb_seed is None else perturb_seed)
    rt = FedRuntime(cfg, model,
                    make_gpt2_train_loss(model, cfg.lm_coef, cfg.mc_coef,
                                         cfg.lm_chunk),
                    device="cpu",
                    loss_fn_val=make_gpt2_val_loss(model, cfg.lm_chunk))
    return rt, train_ds, val_ds


def gpt2_port(argv, epochs, seed=21, perturb=0.0, perturb_seed=None):
    """The port's driver on ``argv`` (``gpt2_port_runtime``) as
    ``gpt2_train`` runs it, for ``epochs`` epochs; returns its rows."""
    from commefficient_torch.core import driver
    from commefficient_torch.utils.schedules import make_gpt2_schedule
    rt, train_ds, val_ds = gpt2_port_runtime(argv, seed, perturb,
                                             perturb_seed)
    rows = Rows(GPT2_COLUMNS, epochs)
    return _run(lambda: driver.train(
        rt, rt.init_state(), train_ds, val_ds, make_gpt2_schedule(rt.cfg),
        loggers=(rows,), eval_before_start=rt.cfg.eval_before_start), rows)


def swapped_rounds(argv, rounds, seed=21, perturb=1e-7):
    """One round of each package from the JAX package's state and inputs
    at each of ``rounds`` of its run of ``argv``: for each, how far the
    port's step (the change of the weights, error and velocity) lies from
    the JAX package's, as a share of the JAX step's L2 norm, and the
    share of the JAX update's support that the port's update shares;
    beside them, the same for the JAX package's own step from that state
    with its weights scaled by 1 + ``perturb`` N(0, 1), a reference for
    how far float noise moves a step. Returns one dict a round."""
    import jax
    import torch
    from commefficient_tpu.core import FedRuntime as JRuntime
    want, seen, n = set(rounds), {}, [0]
    orig = JRuntime.round

    def host(tree):
        # the round donates its state: keep host copies
        return jax.tree.map(np.array, tree)

    def capture(self, state, client_ids, batch, mask, lr, *args, **kw):
        n[0] += 1
        inputs = host((state, client_ids, batch, mask, lr)) \
            if n[0] in want else None
        new, metrics = orig(self, state, client_ids, batch, mask, lr,
                            *args, **kw)
        if inputs is not None:
            seen[n[0]] = (self, *inputs, host(new))
            if len(seen) == len(want):
                raise _Stop
        return new, metrics

    JRuntime.round = capture
    try:
        gpt2_jax(argv, 10 ** 6, seed)
    finally:
        JRuntime.round = orig
    rt = gpt2_port_runtime(argv, seed)[0]
    template = rt.init_state()
    fields = ("ps_weights", "Vvelocity", "Verror")

    def step(old, new):
        return {f: np.asarray(new[f], np.float64)
                - np.asarray(old[f], np.float64) for f in fields}

    def distance(a, b):
        out = {f: float(np.linalg.norm(a[f] - b[f])
                        / np.linalg.norm(b[f])) for f in fields}
        sa, sb = a["ps_weights"] != 0, b["ps_weights"] != 0
        out["support_shared"] = float((sa & sb).sum() / sb.sum())
        return out

    def arrays(state):
        return {f: np.asarray(getattr(state, f)) for f in fields}

    out = []
    for r in sorted(seen):
        jrt, state, ids, batch, mask, lr, new = seen[r]
        old = arrays(state)
        ts = template.replace(step=int(state.step), **{
            f: torch.from_numpy(np.array(getattr(state, f)))
            for f in ("ps_weights", "Vvelocity", "Verror",
                      "coord_last_update", "client_last_round",
                      "nan_round")
            if getattr(template, f) is not None})
        tnew, _ = rt.round(ts, np.asarray(ids),
                           {k: np.asarray(v) for k, v in batch.items()},
                           np.asarray(mask), float(np.asarray(lr)))
        w = state.ps_weights
        noise = np.random.default_rng(r).standard_normal(w.shape)
        pnew, _ = orig(jrt, *jax.tree.map(jax.numpy.asarray, (
            state.replace(ps_weights=(w * (1 + perturb * noise)).astype(
                w.dtype)), ids, batch, mask, lr)))
        jstep = step(old, arrays(new))
        out.append({"round": r, "port": distance(
            step(old, {f: getattr(tnew, f).numpy() for f in fields}),
            jstep), "jax_perturbed": distance(step(old, arrays(pnew)),
                                              jstep)})
    return out


@contextlib.contextmanager
def traced_rounds(runtime_cls, path):
    """While open, each ``runtime_cls.round`` call appends a JSON line to
    ``path``: the round's number, clients and rate, its clients' mean
    loss and the L2 norm and largest magnitude of the new state's
    weights, error and velocity."""
    def norms(x):
        a = np.asarray(x.detach() if hasattr(x, "detach") else x,
                       np.float64)
        return [float(np.sqrt((a * a).sum())), float(np.abs(a).max())]

    orig, n = runtime_cls.round, [0]

    def traced(self, state, client_ids, batch, mask, lr, *args, **kw):
        new, metrics = orig(self, state, client_ids, batch, mask, lr,
                            *args, **kw)
        n[0] += 1
        rec = {"round": n[0],
               "clients": np.asarray(client_ids).tolist(),
               "lr": float(np.asarray(lr)),
               "loss": float(np.mean(np.asarray(metrics["results"][0]))),
               **{key: norms(getattr(new, field)) for key, field in (
                   ("weights", "ps_weights"), ("error", "Verror"),
                   ("velocity", "Vvelocity"))}}
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        return new, metrics

    runtime_cls.round = traced
    try:
        yield
    finally:
        runtime_cls.round = orig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("recipe", choices=("hard_v2", "gpt2"))
    ap.add_argument("--arm", default="gpt2_true_topk24_clip")
    ap.add_argument("--load", type=int, default=None,
                    help="cut a sketch arm's --num_cols to ceil(d / LOAD) "
                    f"of the narrow model's d (the EF cases: {GPT2_LOAD})")
    ap.add_argument("--perturb", type=float, default=0.0)
    ap.add_argument("--perturb_seed", type=int, default=None)
    ap.add_argument("--swap", default=None,
                    help="gpt2: comma-separated rounds at which each "
                    "package steps once from the JAX package's state "
                    "(``swapped_rounds``)")
    ap.add_argument("--trace", default=None,
                    help="gpt2: write each round's clients, rate, loss and "
                    "state norms "
                    "to TRACE.<package>.jsonl")
    ap.add_argument("--width", choices=("narrow", "full"), default="full")
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--package", choices=("both", "jax", "port"),
                    default="both")
    ap.add_argument("--seed", type=int, default=21)
    ap.add_argument("--compute_dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--out", default=None,
                    help="data directory (default: a new temp dir)")
    ap.add_argument("--jax_root", default=None,
                    help="a directory holding another tree's "
                    "commefficient_tpu/ (git archive COMMIT "
                    "commefficient_tpu), run in place of this one's")
    args = ap.parse_args(argv)
    if args.jax_root:
        sys.path.insert(0, os.path.abspath(args.jax_root))
    # outside pytest: the root conftest's jax shim, as a test session has it
    spec = importlib.util.spec_from_file_location(
        "root_conftest", os.path.join(ROOT, "conftest.py"))
    shim = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(shim)
    shim.pytest_configure(None)
    out = args.out or tempfile.mkdtemp(prefix="curve_parity_")
    if args.swap:
        argv_ = gpt2_argv(args.arm, os.path.join(out, "jax"), args.seed,
                          args.load)
        for rec in swapped_rounds(argv_, [int(r) for r in
                                          args.swap.split(",")],
                                  args.seed):
            print(json.dumps({"arm": args.arm, **rec}), flush=True)
        return 0
    channels = NARROW if args.width == "narrow" else None
    for pkg in (("jax", "port") if args.package == "both"
                else (args.package,)):
        abort = None
        if args.recipe == "gpt2":
            argv_ = gpt2_argv(args.arm, os.path.join(out, pkg), args.seed,
                              args.load)
            if pkg == "jax":
                from commefficient_tpu.core import FedRuntime as runtime
            else:
                from commefficient_torch.core.runtime import \
                    FedRuntime as runtime
            with (traced_rounds(runtime, f"{args.trace}.{pkg}.jsonl")
                  if args.trace else contextlib.nullcontext()):
                rows, abort = with_abort(
                    gpt2_jax if pkg == "jax" else gpt2_port, argv_,
                    args.epochs, args.seed, args.perturb,
                    args.perturb_seed)
            columns, what = GPT2_COLUMNS, {
                "arm": args.arm, "load": args.load,
                "num_cols": int(argv_[argv_.index("--num_cols") + 1])
                if "--num_cols" in argv_ else None}
        else:
            argv_ = hard_v2_argv(os.path.join(out, pkg), args.seed,
                                 dtype=args.compute_dtype)
            rows = (hard_v2_jax(argv_, args.epochs, args.seed, channels)
                    if pkg == "jax" else
                    hard_v2_port(argv_, args.epochs, args.seed, channels,
                                 args.perturb))
            columns, what = CV_COLUMNS, {"width": args.width,
                                         "compute_dtype": args.compute_dtype}
        for e, row in enumerate(rows):
            print(json.dumps({"package": pkg, "jax_root": args.jax_root,
                              "perturb": args.perturb, "seed": args.seed,
                              **what, "epoch": e + 1,
                              **dict(zip(columns, row))}), flush=True)
        if abort is not None:
            print(json.dumps({"package": pkg, "perturb": args.perturb,
                              "seed": args.seed, **what,
                              "abort_round": abort}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
