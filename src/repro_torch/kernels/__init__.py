"""Hand-written CUDA kernels for Hopper (``csrc/``), each with a plain
PyTorch version in ``ref.py`` and a wrapper that routes by tensor device:

  * neuron_step     -- the step's head in one launch: ring slot + drive,
                       LIF+SFA, slot zeroing, the delivered-row bitmap
                       and the spike count (the engine's path)
  * lif_step        -- fused memory-bound LIF+SFA neuron update
  * synaptic_accum  -- event delivery: one block per target column
                       accumulates its ring window in shared memory over
                       the tier's run descriptor (bfloat16 weights,
                       where the order of the adds is exact)
  * plastic_step    -- fixed-order delivery fused with STDP's LTD: one
                       warp per target pulls its delivered synapses
                       through the inverse index in the reference's
                       order (float32 weights)
  * spike_compact   -- stream compaction of the spike vector by an int32
                       block prefix scan (the spike recorder)
  * flash_attention -- blocked online-softmax attention with causal and
                       sliding-window masks and GQA (the LM prefill):
                       bf16 and 3xTF32 float32 on the tensor cores at
                       every head_dim

``_build`` compiles the sources with ``nvcc`` at first use and counts
every launch.
"""

from . import ops, ref
