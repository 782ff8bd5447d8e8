"""The benchmark of DIAL's PyTorch/CUDA port (``repro_torch``).

``python3 dialbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``; see
:mod:`dialbench.harness`.  The benchmark's plain reference is
:mod:`dialbench.reference`; the only module that imports the program
is :mod:`dialbench.program`.
"""
