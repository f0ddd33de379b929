"""The benchmark entry points of the PyTorch port, counterparts of the JAX
package's ``bench.py``, ``bench_gpt2.py``, ``bench_common.py`` and the
bench scripts under ``scripts/``. Each module keeps its counterpart's
name, runs as ``python -m commefficient_torch.bench.<name>`` (on the card
unless ``--device cpu``) and prints its counterpart's JSON line:

- ``bench``: the ResNet-9 FetchSGD round (headline), its saturated point
  and the GPT-2 round nested under ``gpt2``;
- ``bench_gpt2``: the GPT-2 sketched round, and ``ledger_ab``;
- ``bench_imagenet``: FixupResNet50 at 224 x 224, both input layouts;
- ``round_shape_grid``: the CIFAR round over clients x local batch;
- ``gpt2_mfu_sweep``: arms of ``bench_gpt2.run``, one JSONL line each;
- ``bench_gpt2_model``: the bare GPT-2 step, remat x attention;
- ``bench_longctx``: ``GPT2LMHead`` at S = 1024, 2048, 4096.
"""
