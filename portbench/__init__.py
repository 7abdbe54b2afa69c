"""portbench: the benchmark of tpu_audio_torch (the PyTorch and CUDA port).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on one CUDA card
and prints one JSON line. Everything a cell needs is found by name:
``configs/<config>.json``, ``traffic/<traffic>.json`` (whose ``kind`` names
``generators/<kind>.py``) and ``metrics/<metric>.py``. Nothing here imports
JAX or the JAX package.
"""
