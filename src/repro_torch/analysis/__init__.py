"""Post-hoc analysis of the port's telemetry artifacts.

``roofline`` holds the card's peak rates (:class:`HardwareSpec` and the
NVIDIA parts the port runs on, looked up by device name with
:func:`spec_for`); ``diff`` compares two obs dumps or two benchmark
artifacts; ``report`` (``python -m repro_torch.analysis.report``) renders
an ``obs.dump()`` snapshot as the dashboard, the bandwidth attribution,
the request waterfall, the per-matrix explain report or a diff.
"""
