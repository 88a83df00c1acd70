"""The single-shard DPSNN simulator in PyTorch: connectivity laws,
column-grid decomposition, synapse tables, LIF+SFA dynamics, STDP and
the engine (static, plastic and recorded runs)."""

from .connectivity import (ConnectivityLaw, exponential_law, gaussian_law,
                           expected_synapse_counts)
from .grid import ColumnGrid, TileDecomposition, choose_tiling
from .neuron import LIFParams, init_state, lif_sfa_step
from .synapses import (SynapseTables, SynapseTableSpec, TableStorage,
                       TierPlan, build_tables, compress_tables)
from .stdp import STDPParams, build_inverse_index
from .engine import (EngineConfig, build_shard_tables, firing_rate_hz,
                     init_plasticity, init_sim_state, simulate)
