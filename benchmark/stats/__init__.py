"""One module a statistic a traffic mix names (``"statistic"``): how an
evaluation calls the program, what the plain reference computes in its
place, the numbers that compare the two, and the work an evaluation does for
the per-layer metrics. The harness loads them by file name."""
