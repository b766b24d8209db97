"""Model family built on the FFT stack (torch port of
``fft_wgpu_tpu.models``).

* spectral — FNO-style 1-D/2-D/3-D spectral operators + training steps
* poisson — spectral Poisson solver (local and distributed pencil)
* navier_stokes — pseudo-spectral 2-D Navier-Stokes (vorticity form)
* burgers — pseudo-spectral 1-D viscous Burgers (FNO data generator)
* ks — Kuramoto-Sivashinsky ETDRK4 exponential integrator
* ns3d — distributed pseudo-spectral 3-D Navier-Stokes (pencil mesh)
* nlse — split-step Fourier NLSE / Gross-Pitaevskii (1-D/2-D)
"""

from .burgers import (
    burgers_init,
    burgers_rollout,
    burgers_step,
    cole_hopf_solution,
    random_initial_condition,
)
from .ks import ks_init, ks_rollout, ks_step, kt_initial_condition
from .navier_stokes import ns2d_init, ns2d_rollout, ns2d_step, taylor_green_vorticity
from .nlse import (
    bright_soliton,
    free_gaussian,
    nlse_init,
    nlse_rollout,
    nlse_step,
)
from .ns3d import abc_flow, ns3d_init, ns3d_rollout, ns3d_step
from .poisson import solve_poisson, solve_poisson_distributed
from .spectral import (
    FNO1d,
    FNO2d,
    FNO3d,
    fno1d_apply,
    fno2d_apply,
    from_numpy,
    init_fno1d,
    init_fno2d,
    mse_loss,
    train_step,
)
