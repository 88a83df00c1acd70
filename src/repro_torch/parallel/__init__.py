"""Sharding rules (logical axis names -> rank mesh axes: DP, FSDP, TP,
EP) and the collectives that a sharded step needs (the port of
``repro.parallel``; ``compat.py``'s JAX shims have no counterpart)."""

from .sharding import (MULTI_POD_RULES, SINGLE_POD_RULES, MeshRules,
                       constrain, rules_for_mesh)

__all__ = ["MULTI_POD_RULES", "MeshRules", "SINGLE_POD_RULES", "constrain",
           "rules_for_mesh"]
