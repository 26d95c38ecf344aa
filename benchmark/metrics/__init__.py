"""One module a per-layer metric of ``BENCHMARK.json``, named as the metric.
Each gives ``UNIT`` and ``read(trace)``: the metric from the traced window
(``benchmark.trace.Trace``), or None where the window holds nothing it
reads. Kernels are grouped by substrings of their names, listed in the
module that uses them."""
