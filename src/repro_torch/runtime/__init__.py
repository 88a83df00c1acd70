"""Fault-tolerant runtime of the port: the generic and the segmented
simulation drivers, and typed simulation jobs."""

from .driver import (DriverConfig, FaultTolerantLoop, StragglerWatchdog,
                     TrainDriver)
from .jobs import JobError, SimJobSpec, build_sim_driver
from .sim_driver import SimDriver, sim_fingerprint
