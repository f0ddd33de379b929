"""The PyTorch port's counterparts of the JAX package's stream readers,
crash harness and study recipes under ``scripts/``. Each module keeps its
counterpart's name, usage line and exit statuses, runs as ``python -m
commefficient_torch.scripts.<name>`` and imports nothing of the JAX
package or of ``scripts/``:

- ``check_telemetry_schema``: lint ``telemetry.jsonl`` streams;
- ``teleview``: the offline analyzer's ten subcommands;
- ``bench_imagenet_model``: the bare FixupResNet50 step at 224 x 224;
- ``crash_matrix``: kill a child at each fault point, resume, compare;
- ``curves``: the learning-curve study recipes and ``curve_band``;
- ``make_persona_corpus`` and ``gpt2log2tsv``: GPT-2's synthetic
  PersonaChat corpus and its log-to-TSV parser.
"""
