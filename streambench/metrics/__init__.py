"""One reader a metric, ``<metric>.py``, found by the metric's name in
``BENCHMARK.json``: ``read(run)`` returns the number from a
:class:`streambench.harness.Run`, or None when the run has nothing to
read (the harness then leaves the metric out of the line)."""
