"""The benchmark of the PyTorch and CUDA port (``ppl.llm.serving_tpu_torch``)
on one H100: ``python3 -m port_bench.run --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` (see ``run.py``). Its cells, configurations
and metrics are named in ``BENCHMARK.json`` at the repository's root; the
files each name finds sit in ``configs/``, ``traffic/``, ``cells/`` and
``metrics/``."""
