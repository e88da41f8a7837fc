"""The benchmark of ``synthesizer_tpu_torch`` on one NVIDIA H100: a
harness driven by data (``BENCHMARK.json``, ``configs/``, ``workloads/``,
``drivers/``, ``metrics/``), frozen input generators (``inputs/``) and the
plain reference that decides ``correct`` (``reference/``).

    python3 benchmark/run.py --workload demo_song.render --seed 1 \
        --seconds 51 --trace 0
"""
