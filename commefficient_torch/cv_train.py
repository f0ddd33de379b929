"""Federated CV training entry point of the PyTorch port: any model of
the registry (``models.MODEL_NAMES``: ResNet-9, the Fixup ResNets, ResNet-18,
the torchvision family and ResNet101LN) on CIFAR10, CIFAR100, LEAF
FEMNIST (``--dataset_name EMNIST``) or ImageNet, in every mode of the JAX
package's single-device round.

    python -m commefficient_torch.cv_train --dataset_name CIFAR10 \\
        --dataset_dir ./dataset --model ResNet9 --mode sketch \\
        --error_type virtual --local_momentum 0 --virtual_momentum 0.9 \\
        --num_workers 8 --local_batch_size 64 --k 50000 --num_rows 5 \\
        --num_cols 500000 --checkpoint_every 1

    python -m commefficient_torch.cv_train --dataset_name EMNIST \\
        --dataset_dir ./femnist --model ResNet101LN --mode sketch \\
        --error_type virtual --virtual_momentum 0.9 --local_momentum 0 \\
        --num_workers 8 --local_batch_size 16 --k 50000 --num_rows 5 \\
        --num_cols 500000

    python -m commefficient_torch.cv_train --dataset_name ImageNet \\
        --dataset_dir ./dataset/imagenet --model FixupResNet50 \\
        --mode uncompressed --error_type virtual --virtual_momentum 0.9 \\
        --local_momentum 0 --weight_decay 1e-4 --num_epochs 24 \\
        --pivot_epoch 2 --lr_scale 0.4 --num_workers 7 --num_clients 7 \\
        --iid --local_batch_size 64 --valid_batch_size 64 \\
        --mesh_shape "" --checkpoint --checkpoint_every 1

``--mode`` takes sketch, true_topk, local_topk, fedavg or uncompressed
(fedavg with ``--local_batch_size -1 --error_type none --local_momentum
0``); ``--sketch_impl`` circ, hash or rht; ``--max_grad_norm``,
``--sketch_dense_clip``, ``--dp``, ``--topk_down`` and
``--sketch_server_state dense`` as in the JAX package. A model whose name
starts with ``Fixup`` trains its scalar biases and scales at a tenth of
the rate (``fixup_lr_multiplier``). Runs on the card unless ``--device
cpu`` is given. At each epoch's end it prints the epoch's rounds (loss,
accuracy, round time), validates, and prints the reference's epoch row
(train and test loss and accuracy, download and upload MiB); at the end
the run's byte totals and the TSV record.

The data is read from ``--dataset_dir``, prepared there once: the CIFAR
python pickles (``cifar-10-batches-py`` or ``cifar-100-python``,
data/fed_cifar.py), LEAF FEMNIST's ``train/`` and ``test/``
``all_data*.json`` (data/fed_emnist.py) or an ImageNet ``train/<wnid>/``
image tree, resized to 224 x 224 (data/fed_imagenet.py); without them a
synthetic set is generated there, with a ``WARNING:`` (ImageNet raises
instead, unless ``--test`` asks for its synthetic set; CIFAR's
``--synthetic_hard`` regime and ``--synthetic_label_noise`` as in the JAX
package). ``--iid`` deals a fixed
permutation of the train set to ``--num_clients`` clients. When the set
fits (2 GiB), its arrays live on the device and every round is gathered
and augmented there (data/device_store.py; ``--no_augment``: normalised
only); the run says which path feeds it. ``--test`` runs the JAX
package's smoke size (one-channel ResNet-9s, a 1 x 10 sketch, synthetic
data). ``--checkpoint_every N`` writes the whole state every N epochs
under ``--checkpoint_path``, ``--resume`` continues from the newest
intact checkpoint, and ``--checkpoint`` writes the final weights to
``<checkpoint_path>/<model>.npz`` (checkpoint.py). ``--finetune
--finetuned_from D`` reads ``<finetune_path>/<model>.npz`` (a model
trained on dataset D, written by either package's ``--checkpoint``),
freezes its backbone and trains a zeroed head at the dataset's class
count: the federated vector is the head alone. On the host path each
round's batch is fetched a round or more ahead on a worker thread
(``--prefetch_depth``; ``--no_pipeline`` fetches inline, the same
rounds); the device store's fetch runs inline.

The runtime services, with the JAX package's flags: ``--defense
normclip|trim`` aggregates robustly, ``--adversary
labelflip|signflip|scale|noise|nan --adversary_frac F`` makes a
deterministic fraction of the clients hostile, ``--nonfinite_action
quarantine`` zeroes a client whose upload went nonfinite out of the round
and benches it (``--quarantine_backoff``, ``--quarantine_strikes``); the
rows then print the defense scalars. ``--async_agg`` runs FedBuff's
buffered rounds (``--max_inflight``, ``--buffer_goal``,
``--staleness_discount``, ``--staleness_alpha``) under a straggler
``--scenario`` (``--scenario_*``). A first SIGTERM or SIGINT drains
within ``--preempt_grace`` seconds to a ``preempt``-tagged checkpoint
(with ``--checkpoint_every``) and exits 0; ``--resume`` continues at its
round. ``--watchdog`` deadlines each round (``--watchdog_mult``).
``COMMEFFICIENT_FAULT=<kill|sigterm>:<point>[:<round>]`` plants a fault
(faults.py).
"""

from __future__ import annotations

import argparse
import math
import os
import sys
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from commefficient_torch.checkpoint import setup_checkpointing
from commefficient_torch.config import (CV_DATASETS, add_args,
                                        config_from_args, parse_known)
from commefficient_torch.core.driver import (make_writer, open_telemetry,
                                              train)
from commefficient_torch.core.runtime import FedRuntime
from commefficient_torch.data.device_store import (DATA_KEY,
                                                   make_device_store)
from commefficient_torch.data import fed_cifar
from commefficient_torch.data.fed_emnist import FedEMNIST
from commefficient_torch.data.fed_imagenet import FedImageNet
from commefficient_torch.data.transforms import transforms_for
from commefficient_torch.losses import FrozenBackbone, make_cv_loss
from commefficient_torch.ops.pytree import layout_leaves
from commefficient_torch.parallel.mesh import setup_mesh
from commefficient_torch.models import get_model
from commefficient_torch.utils.logging import TableLogger, Timer, TSVLogger
from commefficient_torch.utils.schedules import lr_schedule_for


DATASETS = {**fed_cifar.DATASETS, "EMNIST": FedEMNIST,
            "ImageNet": FedImageNet}
# the top-level scopes a finetune retrains (the JAX package's)
HEAD_KEYS = ("head", "classifier", "fc")
# more batch-stat norm scopes than this, evaluated in batches below
# VALID_BATCH_WARN, draw the JAX package's warning: ResNet-9's 8 norms are
# robust at batch 8, the 20+ of the depth-18+ models are not
BSN_WARN_SCOPES = 10
VALID_BATCH_WARN = 64


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_args(p)
    p.add_argument("--test", action="store_true", dest="do_test",
                   help="smoke size: one-channel ResNet-9s, a 1 x 10 "
                        "sketch, synthetic data")
    p.add_argument("--num_rounds", type=int, default=0,
                   help="stop after this many rounds (0 = run num_epochs)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--checkpoint", action="store_true",
                   dest="do_checkpoint",
                   help="write the final weights to "
                        "<checkpoint_path>/<model>.npz")
    return p


def build_model(cfg, num_classes: int, device=None):
    """The registry's ``--model`` at the dataset's NHWC input shape
    (``cfg.input_shape``), with weights drawn from a generator seeded by
    ``--seed`` (``device="meta"``: the layout alone); the JAX package's
    rules: ``--batchnorm`` reaches ResNet9 alone, ``--test``'s
    one-channel widths the two ResNet-9s alone."""
    kwargs = {"num_classes": num_classes}
    if cfg.do_test:
        kwargs["channels"] = {"prep": 1, "layer1": 1, "layer2": 1,
                              "layer3": 1}
    ctor = get_model(cfg.model)
    if cfg.model == "ResNet9":
        kwargs["do_batchnorm"] = cfg.do_batchnorm
    elif cfg.model != "FixupResNet9":
        kwargs.pop("channels", None)
    return ctor(input_shape=cfg.input_shape,
                generator=torch.Generator().manual_seed(cfg.seed),
                device=device, **kwargs)


def fixup_lr_multiplier(layout: List[Tuple[str, Tuple]]) -> torch.Tensor:
    """The Fixup models' per-parameter rate multipliers, as a (d,) float32
    vector in ravel order: 0.1 where the parameter's path holds ``bias``
    or ``scale``, 1.0 elsewhere (the JAX package's
    ``fixup_lr_multiplier``)."""
    return torch.cat([
        torch.full((math.prod(shape),),
                   0.1 if ("bias" in path or "scale" in path) else 1.0,
                   dtype=torch.float32)
        for path, shape in layout])


def warn_small_eval_batches(cfg, layout) -> None:
    """The JAX package's warning: batch-stat norms normalise an eval batch
    by its own statistics, and in a deep stack a small batch's noise
    compounds to chance-level accuracy."""
    scopes = set()
    for path, _ in layout:
        keys = path.split("/")
        hits = [i for i, k in enumerate(keys) if "BatchStatNorm" in k]
        if hits:
            scopes.add("/".join(keys[:hits[0] + 1]))
    if len(scopes) > BSN_WARN_SCOPES and \
            cfg.valid_batch_size < VALID_BATCH_WARN:
        print(f"WARNING: {cfg.model} stacks {len(scopes)} batch-stat norm "
              f"layers and --valid_batch_size {cfg.valid_batch_size} < "
              f"{VALID_BATCH_WARN}: eval batches normalize by their OWN "
              "statistics, and small-batch stat noise compounds with depth "
              "(measured: chance-level val accuracy at depth 50 / batch 8 "
              "where batch 256 tracks train). Raise --valid_batch_size.",
              file=sys.stderr)


def build_datasets(cfg):
    """The train and validation ``FedDataset``s of ``--dataset_name`` under
    ``--dataset_dir``, with no host transform yet (``make_stores``
    installs one where no store feeds the split), and the JAX package's
    guards: ``--synthetic_hard`` only for CIFAR's synthetic generator,
    and never over real data (the run would train on it and ignore the
    flag)."""
    ds_cls = DATASETS[cfg.dataset_name]
    kw = {"synthetic": True} if cfg.do_test else {}
    if cfg.dataset_name != "EMNIST":
        kw["synthetic_per_class"] = cfg.synthetic_per_class
    if cfg.synthetic_hard:
        if cfg.dataset_name not in fed_cifar.DATASETS:
            raise ValueError(
                "--synthetic_hard is a CIFAR synthetic-generator knob; it "
                f"does nothing for {cfg.dataset_name}")
        if ds_cls._has_real_source(cfg.dataset_dir):
            raise ValueError(
                f"--synthetic_hard set but real data exists under "
                f"{cfg.dataset_dir} (the dataset would train on it and "
                "ignore the flag); remove the flag or point --dataset_dir "
                "elsewhere")
    if cfg.dataset_name in fed_cifar.DATASETS:
        kw["synthetic_hard"] = cfg.synthetic_hard
        kw["synthetic_label_noise"] = cfg.synthetic_label_noise
    train_ds = ds_cls(cfg.dataset_dir, train=True, do_iid=cfg.do_iid,
                      num_clients=cfg.num_clients, **kw)
    val_ds = ds_cls(cfg.dataset_dir, train=False, **kw)
    return train_ds, val_ds


class TrainableView:
    """What ``FedRuntime`` reads of a model, for a finetune: the trainable
    leaves' ``layout`` (ravel order), their ``num_params`` and the
    initial vector ``flat``, zeros."""

    def __init__(self, layout):
        self.layout = list(layout)
        self.num_params = sum(math.prod(shape) for _, shape in self.layout)
        self.flat = torch.zeros(self.num_params)


def load_finetune_params(cfg, model, device="cpu"):
    """The JAX package's ``load_finetune_params``: the weights of
    ``<finetune_path>/<model>.npz`` (``ps_weights``, as both packages'
    ``--checkpoint`` write it), read in the layout of the model at
    ``--finetuned_from``'s class count. The first of its top-level scopes
    named ``head``, ``classifier`` or ``fc`` trains again, zeroed, at the
    dataset's class count (the layout of ``model``); every other scope is
    frozen. Returns ``(TrainableView, FrozenBackbone on device)``. The JAX
    package applies the merged tree to the model built at the old class
    count, which Flax refuses when the counts differ; here the model is
    built at the new count and the saved backbone carries over leaf by
    leaf."""
    path = os.path.join(cfg.finetune_path, cfg.model + ".npz")
    with np.load(path) as f:
        loaded = torch.from_numpy(np.asarray(f["ps_weights"], np.float32))
    saved = build_model(cfg, CV_DATASETS[cfg.finetuned_from][0],
                        device="meta")
    if loaded.numel() != saved.num_params:
        raise ValueError(
            f"{path} holds {loaded.numel()} weights; {cfg.model} trained "
            f"on {cfg.finetuned_from} has {saved.num_params}")
    weights = layout_leaves(loaded, saved.layout)
    heads = [k for k in sorted({p.split("/")[1] for p in weights})
             if k in HEAD_KEYS]
    if not heads:
        raise ValueError(f"{cfg.model}: no recognisable head to finetune "
                         f"(a top-level {' / '.join(HEAD_KEYS)} scope)")
    frozen = {p: w for p, w in weights.items()
              if p.split("/")[1] not in heads}
    backbone = FrozenBackbone(model.layout, frozen, device)
    trainable = [(p, s) for p, s in backbone.layout_trainable
                 if p.split("/")[1] == heads[0]]
    if trainable != backbone.layout_trainable:
        raise ValueError(f"{cfg.model}: the saved backbone does not cover "
                         "the model's layout outside its head")
    print(f"finetune: {path} ({cfg.finetuned_from}); training "
          f"{heads[0]} at {cfg.num_classes} classes, "
          f"{sum(math.prod(s) for _, s in trainable)} weights; backbone "
          f"frozen, {sum(w.numel() for w in frozen.values())} weights")
    return TrainableView(trainable), backbone


def setup(ns: argparse.Namespace):
    """Data, model and runtime for the parsed flags ``ns``: returns
    ``(runtime, state, train_ds, val_ds, frozen)``, ``frozen`` the
    finetune's ``FrozenBackbone`` (else None)."""
    cfg = config_from_args(ns)
    if cfg.do_test:
        # the JAX package's smoke size of the sketch
        cfg = cfg.replace(num_cols=10, num_rows=1, k=10)
    device = torch.device(ns.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the "
                         "CPU")
    device, mesh = setup_mesh(cfg, device)
    torch.manual_seed(cfg.seed)
    np.random.seed(cfg.seed)
    # on a mesh rank 0 prepares the data directory, then the others read
    if mesh is not None and mesh.rank != 0:
        mesh.barrier()
    train_ds, val_ds = build_datasets(cfg)
    if mesh is not None and mesh.rank == 0:
        mesh.barrier()
    cfg = cfg.replace(num_clients=train_ds.num_clients)
    model = build_model(cfg, cfg.num_classes)
    warn_small_eval_batches(cfg, model.layout)
    weights, frozen = model, None
    if cfg.do_finetune:
        weights, frozen = load_finetune_params(cfg, model, device)
    loss_fn = make_cv_loss(model, cfg.compute_dtype, frozen=frozen)
    runtime = FedRuntime(cfg, weights, loss_fn, device=device, mesh=mesh)
    cfg = runtime.cfg
    print(f"mode={cfg.mode} d={cfg.grad_size} c={cfg.num_cols} "
          f"r={cfg.num_rows} k={cfg.k} W={cfg.num_workers} "
          f"B={runtime.batch_size} clients={runtime.num_clients} "
          f"{cfg.dataset_name}{' iid' if cfg.do_iid else ''} "
          f"device={device}"
          + (f" mesh={mesh.size} ranks ({mesh.axis}), sharded server "
             f"{'on' if runtime.sharded_server else 'off'}"
             if mesh is not None else ""))
    return runtime, runtime.init_state(), train_ds, val_ds, frozen


def lr_multiplier(runtime: FedRuntime) -> Optional[torch.Tensor]:
    """The (d,) rate multiplier on the runtime's device for a Fixup model
    (built once a run), else None (the scalar rate)."""
    if not runtime.cfg.model.startswith("Fixup"):
        return None
    mult = fixup_lr_multiplier(runtime.layout).to(runtime.device)
    share = float((mult != 1.0).float().mean())
    print(f"using fixup learning rates: a (d,) multiplier, 0.1 on "
          f"{share:.6f} of the {mult.numel()} parameters (scalar biases "
          "and scales), 1.0 elsewhere")
    return mult


def make_stores(runtime: FedRuntime, train_ds, val_ds):
    """The train and validation ``DeviceStore``s, or None for the host
    path, whose dataset then gets its host transform; prints which path
    feeds the rounds."""
    cfg = runtime.cfg
    train_store = make_device_store(train_ds, cfg.dataset_name, True,
                                    runtime.device,
                                    no_augment=cfg.no_augment,
                                    seed=cfg.seed)
    val_store = make_device_store(val_ds, cfg.dataset_name, False,
                                  runtime.device)
    if val_store is None:
        val_ds.transform = transforms_for(cfg.dataset_name, False)
    if train_store is None:
        train_ds.transform = transforms_for(cfg.dataset_name,
                                            not cfg.no_augment,
                                            seed=cfg.seed)
        print("data: host path (the round's batch is gathered and "
              "augmented on the host)")
    else:
        print(f"data: device store on {runtime.device}: train "
              f"{train_store.nbytes / 2**20:.1f} MiB "
              f"({train_store.augment}, draws keyed by seed ^ "
              f"{DATA_KEY:#x} and the round)"
              + (f", val {val_store.nbytes / 2**20:.1f} MiB"
                 if val_store is not None else ""))
    return train_store, val_store


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Runs the flags ``argv``; returns the run's per-round losses,
    host-clock round times, the round's wait for its batch and the
    fetch's own time, the logdir and stream, the last epoch row
    (``summary``, None after a divergence abort), the final state, the
    run's byte totals and a finetune's frozen backbone."""
    timer = Timer()
    ns = parse_known(build_parser(), argv)
    runtime, state, train_ds, val_ds, frozen = setup(ns)
    cfg = runtime.cfg
    lr_mult = lr_multiplier(runtime)
    train_store, val_store = make_stores(runtime, train_ds, val_ds)
    ckpt_mgr, start_epoch, restored, global_round = setup_checkpointing(
        cfg, runtime, cfg.model)
    if restored is not None:
        state = restored
    logdir, telemetry = open_telemetry(cfg, runtime, "cv_train", ckpt_mgr)
    tsv = TSVLogger()
    try:
        state, summary, log = train(
            runtime, state, train_ds, val_ds, lr_schedule_for(cfg),
            ns.num_rounds, loggers=(TableLogger(), tsv), timer=timer,
            train_store=train_store, val_store=val_store,
            ckpt_mgr=ckpt_mgr, checkpoint_every=cfg.checkpoint_every,
            start_epoch=start_epoch, global_round=global_round,
            lr_mult=lr_mult, eval_before_start=cfg.eval_before_start,
            services=True, telemetry=telemetry,
            writer=make_writer(cfg, logdir))
    finally:
        if telemetry is not None:
            telemetry.close()
    print(tsv)
    if cfg.do_checkpoint and summary is not None:
        weights = runtime.flat_weights(state)     # every rank gathers
        if runtime.mesh is None or runtime.mesh.rank == 0:
            os.makedirs(cfg.checkpoint_path, exist_ok=True)
            path = os.path.join(cfg.checkpoint_path, cfg.model + ".npz")
            np.savez(path, ps_weights=weights.cpu().numpy())
            print(f"saved checkpoint to {path}")
    return {"losses": log.losses, "round_s": log.round_s,
            "data_s": log.data_s, "fetch_s": log.fetch_s,
            "epochs": log.epochs,
            "rounds": len(log.losses), "summary": summary, "state": state,
            "val_loss": summary["test_loss"] if summary else float("nan"),
            "val_acc": summary["test_acc"] if summary else float("nan"),
            "total_download_mib": log.total_download_mib,
            "total_upload_mib": log.total_upload_mib,
            "runtime": runtime, "train_store": train_store,
            "lr_mult": lr_mult, "frozen": frozen,
            "defense": log.defense, "services": log.services,
            "preempted": log.preempted, "logdir": logdir,
            "telemetry": telemetry, "log": log}


if __name__ == "__main__":
    main()
