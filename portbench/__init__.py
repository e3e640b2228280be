"""The benchmark of the PyTorch/CUDA port (``video_desensitization_torch``).

``python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell once on the card and prints the result as its last line.
Everything is found by name: ``configs/<config>.json``,
``workloads/<cell>.json``, ``drivers/<driver>.py`` and
``metrics/<metric>.py``. ``reference/`` is the plain PyTorch reference
the outputs are judged by, ``arith/`` the yardstick's own counts.
"""
