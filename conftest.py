"""Session set-up shared by every test of the repository.

jax 0.9's ``PrimitiveBatchersProxy`` has no ``__contains__``, which
``commefficient_tpu/utils/jax_compat.py`` needs when it is imported. The
hook below gives the proxy one, once a session (and once in each xdist
worker), before any test module is collected. It runs in
``pytest_configure``, after ``tests/conftest.py`` has set
``JAX_PLATFORMS=cpu`` and the 8-device ``XLA_FLAGS``, so importing jax
here does not choose the backend early.
"""


def pytest_configure(config):
    try:
        from jax._src.interpreters import batching
    except ImportError:       # no jax: the JAX package's tests skip or fail
        return                # on their own imports
    proxy = getattr(batching, "PrimitiveBatchersProxy", None)
    if proxy is not None and "__contains__" not in vars(proxy):
        proxy.__contains__ = (
            lambda self, k: k in batching.fancy_primitive_batchers)
