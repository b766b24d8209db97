"""The JAX package's examples (``examples/``) on the port: each module has
``main(device=None, small=False)`` and runs as
``python -m fft_wgpu_tpu_torch.examples.<name> [--device cpu] [--small]``.

An example runs on the current CUDA device unless ``device`` names another
(``"cpu"`` for the CPU), at the JAX example's own problem size, and asserts
the JAX example's own check.  ``small`` cuts the size (the CPU tests use it;
the check stays).  ``ns3d_dns`` builds the pencil mesh when it runs in a
process group (``torchrun``), else runs in this process alone.
"""

NAMES = ("any_length", "basic", "basic_inverse", "basic_inverse2", "chebyshev_bvp",
         "mri_recon", "multirate_demo", "navier_stokes_demo", "nlse_demo", "ns3d_dns", "poisson_demo",
         "serving", "spectral_pipeline", "stft_demo", "tf_analysis")
