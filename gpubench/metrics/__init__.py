"""One reader a metric: ``<metric name>.py`` with ``read(window)``,
returning the metric's number, or None where the window holds nothing
for it to read (the metric is then left out of the result)."""
