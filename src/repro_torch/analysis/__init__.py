"""repro-lint for the port: repo-specific contract analysis.

Each checker pass encodes an invariant of the port (see the module
docstrings); the CLI lives at ``repro_torch.launch.lint``.  The passes
are the reference analyzer's (``repro.analysis``) in their torch sense,
under the same names and pragma grammar; ``hopper-geometry`` takes the
place of ``pallas-geometry``.
"""

from .core import Checker, Finding, Module, Project
from .deprecated_api import DeprecatedApiChecker
from .donation import DonationChecker
from .dtype_contracts import DtypeContractsChecker
from .hopper_geometry import HopperGeometryChecker
from .meta_drift import MetaDriftChecker
from .tracer_purity import TracerPurityChecker

ALL_CHECKERS = (
    TracerPurityChecker,
    DeprecatedApiChecker,
    DtypeContractsChecker,
    DonationChecker,
    MetaDriftChecker,
    HopperGeometryChecker,
)

__all__ = [
    "ALL_CHECKERS", "Checker", "Finding", "Module", "Project",
    "TracerPurityChecker", "DeprecatedApiChecker",
    "DtypeContractsChecker", "DonationChecker", "MetaDriftChecker",
    "HopperGeometryChecker",
]
