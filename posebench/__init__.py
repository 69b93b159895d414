"""The benchmark of ``tpupose_torch`` on NVIDIA H100 cards.

``run.py`` runs one cell once (``python3 -m posebench.run --workload <name>
--seed <n> --seconds <s> --trace <0|1>``); ``control.py`` reads the
comparison's two readings over many seeds.  A cell is an entry of the
root's ``BENCHMARK.json``; its files are found by name:

- ``configs/<config>.json``: the model's layer widths and postprocess
  settings, as run;
- ``traffic/<traffic>.json``: the traffic mix, its driver's parameters and
  the limits of the comparison that decides ``correct``;
- ``drivers/<driver>.py``: sets up the program from the seed, answers one
  request per call, computes the reference's answers;
- ``metrics/<metric>.py``: ``read(ctx)`` of one metric, or None where it
  finds nothing to read.

``core/`` holds the shared yardstick (seeded inputs, the frozen output-conv
calibration, FLOP and byte bounds, timing and trace arithmetic) and
``reference/`` the plain PyTorch and numpy reference, which imports nothing
of the port.  CPU tests: ``python -m pytest posebench/tests -q``; the tests
marked ``cuda`` run on the card.
"""
