"""The port's cost models (``perf/costmodel.py``)."""
