"""A narrow ResNet-9 (the channels of tests/test_torch_round.py) in every
mode of the single-device round, the PyTorch port against the JAX
package on the CPU: the same weights (carried across by the converter)
and the same seeded batches, two rounds in float32. Per-round losses are
held to rtol 1e-5, the final weights to atol 1e-6, and the byte vectors,
``coord_last_update`` and ``nan_round`` exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_round import CH  # noqa: E402 (installs the import fix)

from commefficient_tpu.config import FedConfig as JConfig  # noqa: E402
from commefficient_tpu.core import FedRuntime as JRuntime  # noqa: E402
from commefficient_tpu.losses import make_cv_loss as j_make_cv_loss  # noqa
from commefficient_tpu.models.resnet9 import ResNet9 as JResNet9  # noqa

from commefficient_torch.config import FedConfig  # noqa: E402
from commefficient_torch.core.runtime import FedRuntime  # noqa: E402
from commefficient_torch.losses import make_cv_loss  # noqa: E402
from commefficient_torch.models.convert import params_from_jax  # noqa
from commefficient_torch.models.resnet9 import ResNet9  # noqa: E402

W, B, NUM_CLIENTS = 2, 8, 6
COMMON = dict(local_momentum=0.0, virtual_momentum=0.9, weight_decay=5e-4,
              num_workers=W, local_batch_size=B, num_clients=NUM_CLIENTS,
              compute_dtype="float32", k=2000)
MODES = {
    "uncompressed": dict(mode="uncompressed", error_type="none"),
    "true_topk": dict(mode="true_topk", error_type="virtual"),
    "local_topk": dict(mode="local_topk", error_type="local",
                       local_momentum=0.9, lr_scale=0.01),
    "fedavg": dict(mode="fedavg", error_type="none", local_batch_size=-1,
                   max_client_batch=B, fedavg_batch_size=4,
                   virtual_momentum=0.0),
    "sketch_subtract_microbatched": dict(
        mode="sketch", error_type="virtual", num_rows=5, num_cols=4096,
        k=200, sketch_ef="subtract", microbatch_size=4),
    "sketch_unfused": dict(mode="sketch", error_type="virtual",
                           num_rows=5, num_cols=4096, k=200,
                           sketch_fused_encode="off"),
    "sketch_hash_table_clip": dict(mode="sketch", error_type="virtual",
                                   sketch_impl="hash", num_rows=5,
                                   num_cols=4096, k=200, max_grad_norm=1.0),
    "sketch_dense_clip": dict(mode="sketch", error_type="virtual",
                              num_rows=5, num_cols=4096, k=200,
                              max_grad_norm=1.0, sketch_dense_clip=True),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one intra-op thread in this file: at these sizes more
    threads only spin while the test run's other workers share the
    machine's cores."""
    import torch_mesh_ranks as ranks
    with ranks.one_thread():
        yield


@pytest.mark.parametrize("mode", sorted(MODES))
def test_narrow_resnet9_rounds_match_reference(mode):
    kw = dict(COMMON, **MODES[mode])
    jm = JResNet9(num_classes=10, channels=CH)
    params = jm.init(jax.random.PRNGKey(0), jnp.ones((1, 32, 32, 3)))
    jrt = JRuntime(JConfig(**kw, telemetry=False), params,
                   j_make_cv_loss(jm, "float32"), num_clients=NUM_CLIENTS)
    tm = ResNet9(num_classes=10, channels=CH)
    with torch.no_grad():
        tm.flat.copy_(params_from_jax(jax.tree.map(np.asarray, params), tm))
    trt = FedRuntime(FedConfig(**kw), tm, make_cv_loss(tm, "float32"),
                     device="cpu")
    js, ts = jrt.init_state(), trt.init_state()
    rng = np.random.RandomState(1)
    for rnd in range(2):
        image = rng.randn(W, B, 32, 32, 3).astype(np.float32)
        target = rng.randint(0, 10, (W, B))
        mask = np.ones((W, B), bool)
        mask[1, 5:] = False
        ids = rng.choice(NUM_CLIENTS, W, replace=False)
        js, jm_ = jrt.round(js, jnp.asarray(ids.astype(np.int32)),
                            {"image": jnp.asarray(image),
                             "target": jnp.asarray(target)},
                            jnp.asarray(mask), 0.1)
        ts, tm_ = trt.round(ts, ids, {"image": image, "target": target},
                            mask, 0.1)
        np.testing.assert_allclose(tm_["results"][0].numpy(),
                                   np.asarray(jm_["results"][0]), rtol=1e-5)
        for key in ("download_bytes", "upload_bytes"):
            assert np.array_equal(tm_[key].numpy(), np.asarray(jm_[key]))
    w0 = tm.flat.detach().numpy()
    assert (ts.ps_weights.numpy() != w0).sum() > 0
    np.testing.assert_allclose(ts.ps_weights.numpy(),
                               np.asarray(js.ps_weights), rtol=0, atol=1e-6)
    for key in ("coord_last_update", "client_last_round", "nan_round"):
        assert np.array_equal(getattr(ts, key).numpy(),
                              np.asarray(getattr(js, key))), key
