"""Performance tooling of the port: trace exporters of the runtime
telemetry (``perf.trace``), the eager op-level cost counter
(``perf.op_analysis``), the roofline with H100 constants
(``perf.roofline``), the flash kernel's memory credit
(``perf.attention_credit``) and the narrow flash variants' sweep
(``perf.flash_sweep``)."""
