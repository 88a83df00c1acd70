"""Hand-written CUDA kernels for Hopper (``csrc/``), each with a plain
PyTorch version in ``ref.py`` and a wrapper that routes by tensor device:

  * lif_step        -- fused memory-bound LIF+SFA neuron update
  * synaptic_accum  -- event delivery: cumsum compaction, then one warp
                       per spiking row gathers the row and atomically
                       adds its weights into the delay ring

``_build`` compiles the sources with ``nvcc`` at first use and counts
every launch.
"""

from . import ops, ref
