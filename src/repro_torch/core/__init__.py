"""The single-shard DPSNN simulator in PyTorch: connectivity laws,
column-grid decomposition, synapse tables, LIF+SFA dynamics and the
static engine."""

from .connectivity import (ConnectivityLaw, exponential_law, gaussian_law,
                           expected_synapse_counts)
from .grid import ColumnGrid, TileDecomposition, choose_tiling
from .neuron import LIFParams, init_state, lif_sfa_step
from .synapses import (SynapseTables, SynapseTableSpec, TableStorage,
                       TierPlan, build_tables, compress_tables)
from .engine import (EngineConfig, build_shard_tables, firing_rate_hz,
                     init_sim_state, simulate)
