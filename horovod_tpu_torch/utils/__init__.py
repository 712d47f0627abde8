"""The measurement plane: the metrics registry (``metrics``), the timeline
and its clock sync (``timeline``, ``clocksync``), autotuning
(``autotune``) and the stall inspector (``stall``)."""
