"""Observability of the port: the device-side spike recorder, the spike
spool, the activity analysis and the runtime telemetry."""

from .record import (RecorderSpec, init_recorder_state, record_step,
                     recorder_spec, tile_gid_map)
