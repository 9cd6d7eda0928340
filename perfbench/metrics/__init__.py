"""Per-layer metric readers, one module a metric name (``mfu.train`` is
read by ``metrics/mfu.py``, ``ssm_scan_bwd_roofline`` by
``metrics/ssm_scan_bwd_roofline.py``).  Each exposes ``read(name, trace) ->
float | None`` and, where it times one function of the program,
``SPAN``, a ``lib.trace.KernelSpan``.  None means the window held nothing to
read, and the metric is left out of the line."""
