"""One module a statistic a traffic mix names (``"statistic"``): how an
evaluation calls the program, what the plain reference computes in its
place, the numbers that compare the two, and the work an evaluation does for
the per-layer metrics. The harness loads them by file name.

A module may give ``SMALL = {'call': {...}, 'config': {...}}``: the keys of
its call and of the configuration that the CPU tests change to run its
cells at a small size (``benchmark/tests/tiny.py``); without it a cell runs
at the tests' shared small size."""
