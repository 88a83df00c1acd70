"""The paper's SNN configurations for the port (``configs.snn``)."""

from . import snn
