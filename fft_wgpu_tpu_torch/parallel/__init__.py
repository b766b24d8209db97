"""Distributed transforms on ``torch.distributed`` (torch port of
``fft_wgpu_tpu.parallel``): meshes (``mesh``), the pencil, slab and
distributed 1-D FFTs (``pencil``), batch-sharded transforms (``batched``),
multi-process bring-up (``multihost``) and its self-test
(``multihost_selftest``)."""
