"""Checkpoints of the port: atomic, verified, keep-k, async (``store``)."""

from .store import (AsyncCheckpointer, AsyncWriterThread, LeafSpec,
                    checkpoint_meta, latest_step, refuse_meta_drift,
                    restore_checkpoint, save_checkpoint,
                    set_thread_asserts)
