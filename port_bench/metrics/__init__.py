"""The metrics' readers, one module a metric (or a family of split
metrics), each with ``read(ctx, name)`` returning the value or None when
the run holds nothing to read. ``ctx`` is :class:`port_bench.run.Context`.
"""
