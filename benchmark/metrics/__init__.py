"""One reader per metric, found by the metric's name: ``read(rec)`` returns
the number from the run's record, or None where the run has nothing to
read.  A metric that ``BENCHMARK.json`` reports in the run's cell and that
reads None fails the run: a reader never goes silent unseen."""
