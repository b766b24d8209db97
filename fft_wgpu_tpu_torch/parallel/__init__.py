"""Distributed transforms on ``torch.distributed`` (torch port of
``fft_wgpu_tpu.parallel``): meshes (``mesh``), the pencil, slab and
distributed 1-D FFTs (``pencil``), batch-sharded transforms (``batched``),
multi-process bring-up (``multihost``) and its self-test
(``multihost_selftest``), and the FNO-3D training step sharded over a
``dp`` x ``tp`` mesh (``fno``: ``shard_params``, ``gather_params``,
``value_and_grad``, ``train_step``)."""

from .fno import ShardedFNO3d, gather_params, shard_params, train_step, value_and_grad

__all__ = ["ShardedFNO3d", "shard_params", "gather_params", "value_and_grad", "train_step"]
