"""ShortTimeFFT: scipy.signal.ShortTimeFFT-parity sliding-window STFT, the
port of ``fft_wgpu_tpu.ops.short_time_fft``.

An object holding (window, hop, fs) with invertibility through the
canonical dual window, four FFT modes, magnitude / psd scalings and the
full index algebra (p_min / p_max / k_min / k_max / borders) for windows
that are not centred.  It is a plain class, as scipy's is: it holds no
learnable state.  The window algebra is float64 numpy on the host; the
float32 window and dual-window tables live on each device a signal comes
from, built once per device.

* ``stft`` blends scipy's border padding into the signal with two gathers
  on the device (v[k] = c1 * x[i1] + c2 * x[i2]), then transforms every
  slice.  Real input in a one-sided mode with mfft in the
  segment-spectrum envelope runs one launch of the framed-R2C kernel (B20,
  ``cuda_welch.spec_rfft_c64``) on a CUDA tensor, the phase shift as its
  left roll of each padded frame, into complex64 with no merge (the
  ``onesided2X`` multiplier then scales that tensor, and the result is its
  transposed, moved view); anything else frames, pads, rolls and
  transforms through the plan (the R2C, or ``fftn_split`` for complex
  input, two-sided modes and odd mfft).
* ``istft`` inverts each slice (``irfft_last_split``, the C2R kernel for
  pow2 mfft on the card, or ``fftn_split``), multiplies by the dual window
  and overlap-adds the slices as K contiguous slabs (``stft._ola_slabs``).

Real-valued windows only (complex windows are rejected; scipy allows them
but none of the scipy.signal.windows set is complex).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.complex_utils import default_device, is_pair, merge, promote_to_split
from ..core.twiddle import FORWARD, INVERSE
from . import cuda_welch
from .nd import fftn_split
from .rfft import irfft_last_split, rfft_last_split
from .spectral_est import _is_complex
from .stft import _frame, _ola_slabs, _on_card

__all__ = ["ShortTimeFFT"]

_FFT_MODES = ("twosided", "centered", "onesided", "onesided2X")
_PAD_MODES = ("zeros", "edge", "even", "odd")


def _calc_dual_canonical_window(win: np.ndarray, hop: int) -> np.ndarray:
    """Minimal-L2-norm dual window (scipy algorithm); raises ValueError
    if the (win, hop) pair is not invertible."""
    if hop > len(win):
        raise ValueError(f"hop={hop} larger than window length {len(win)}"
                         " => STFT not invertible!")
    w2 = win * win
    DD = w2.copy()
    for k_ in range(hop, len(win), hop):
        DD[k_:] += w2[:-k_]
        DD[:-k_] += w2[k_:]
    relative_resolution = np.finfo(win.dtype).resolution * DD.max()
    if not np.all(DD >= relative_resolution):
        raise ValueError("Short-time Fourier Transform not invertible!")
    return win / DD


class ShortTimeFFT:
    """Sliding-window STFT/ISTFT with scipy.signal.ShortTimeFFT semantics.

    The zeroth slice is centered at t = 0 (sample index 0); slice p is
    centered at t = p * hop / fs, covering signal samples
    [p*hop - m_num_mid, p*hop - m_num_mid + m_num).

    A tensor is transformed on its own device; other input goes to
    ``device`` (the current CUDA device when None).
    """

    def __init__(self, win, hop: int, fs: float, *,
                 fft_mode: str = "onesided", mfft: int | None = None,
                 dual_win=None, scale_to: str | None = None,
                 phase_shift: int | None = 0, device=None):
        if isinstance(win, torch.Tensor):
            win = win.detach().cpu().numpy()
        if np.iscomplexobj(win):
            raise ValueError("complex windows are not supported")
        win = np.asarray(win, np.float64)
        if win.ndim != 1 or win.size == 0:
            raise ValueError("win must be a non-empty 1-D array")
        if not np.all(np.isfinite(win)):
            raise ValueError("win must be finite")
        if not (isinstance(hop, (int, np.integer)) and hop >= 1):
            raise ValueError(f"hop={hop} must be a positive integer")
        if fft_mode not in _FFT_MODES:
            raise ValueError(f"fft_mode={fft_mode!r} not in {_FFT_MODES}")
        self._win = win
        self._hop = int(hop)
        self._fs = float(fs)
        self.fft_mode = fft_mode
        self._mfft = int(mfft) if mfft is not None else len(win)
        if self._mfft < len(win):
            raise ValueError("mfft must be >= window length")
        if phase_shift is not None and not (
                -self.mfft < phase_shift < self.mfft):
            raise ValueError(f"phase_shift={phase_shift} out of range")
        self.phase_shift = phase_shift
        if isinstance(dual_win, torch.Tensor):
            dual_win = dual_win.detach().cpu().numpy()
        self._dual_win = (None if dual_win is None
                          else np.asarray(dual_win, np.float64))
        if self._dual_win is not None and self._dual_win.shape != win.shape:
            raise ValueError("dual_win must have the same shape as win")
        self.device = None if device is None else torch.device(device)
        self._scaling = None
        self._tables: dict = {}  # (name, device) -> float32 tensor
        if scale_to is not None:
            self.scale_to(scale_to)
        if fft_mode == "onesided2X" and self._scaling is None:
            raise ValueError(
                "fft_mode='onesided2X' requires scale_to 'magnitude' or "
                "'psd' (scipy parity)")

    # ---- window / scaling ----
    @property
    def win(self):
        return self._win

    @property
    def hop(self) -> int:
        return self._hop

    @property
    def fs(self) -> float:
        return self._fs

    @property
    def T(self) -> float:
        return 1.0 / self._fs

    @property
    def mfft(self) -> int:
        return self._mfft

    @property
    def m_num(self) -> int:
        return len(self._win)

    @property
    def m_num_mid(self) -> int:
        return self.m_num // 2

    @property
    def scaling(self):
        return self._scaling

    @property
    def fac_magnitude(self) -> float:
        if self._scaling == "magnitude":
            return 1.0
        return 1.0 / abs(self._win.sum())

    @property
    def fac_psd(self) -> float:
        if self._scaling == "psd":
            return 1.0
        return 1.0 / np.sqrt((self._win ** 2).sum() / self.T)

    def scale_to(self, scaling: str):
        """Scale the window (and dual) for 'magnitude' or 'psd' STFT."""
        if scaling not in ("magnitude", "psd"):
            raise ValueError(f"scaling={scaling!r} not in ('magnitude','psd')")
        if self._scaling == scaling:
            return
        s_fac = self.fac_psd if scaling == "psd" else self.fac_magnitude
        self._win = self._win * s_fac
        if self._dual_win is not None:
            self._dual_win = self._dual_win / s_fac
        self._scaling = scaling
        self._tables.clear()

    @property
    def dual_win(self):
        if self._dual_win is None:
            self._dual_win = _calc_dual_canonical_window(self._win, self._hop)
        return self._dual_win

    @property
    def invertible(self) -> bool:
        try:
            return len(self.dual_win) > 0
        except ValueError:
            return False

    def _table(self, name: str, device) -> torch.Tensor:
        """The float32 table ``name`` on ``device``, built once per device:
        "win", "dual" or the onesided2X bin multiplier "mult" (its inverse,
        "imult")."""
        key = (name, str(device))
        tab = self._tables.get(key)
        if tab is None:
            if name == "win":
                a = self._win
            elif name == "dual":
                a = self.dual_win
            else:
                fac = np.sqrt(2.0) if self._scaling == "psd" else 2.0
                a = np.full(self.mfft // 2 + 1, fac if name == "mult" else 1.0 / fac)
                a[0] = 1.0
                if self.mfft % 2 == 0:
                    a[-1] = 1.0
            tab = torch.from_numpy(np.asarray(a, np.float32)).to(device)
            self._tables[key] = tab
        return tab

    # ---- frequency axis ----
    @property
    def onesided_fft(self) -> bool:
        return self.fft_mode in ("onesided", "onesided2X")

    @property
    def f_pts(self) -> int:
        return self.mfft // 2 + 1 if self.onesided_fft else self.mfft

    @property
    def delta_f(self) -> float:
        return 1.0 / (self.mfft * self.T)

    @property
    def f(self):
        if self.onesided_fft:
            return np.fft.rfftfreq(self.mfft, self.T)
        if self.fft_mode == "centered":
            return np.fft.fftshift(np.fft.fftfreq(self.mfft, self.T))
        return np.fft.fftfreq(self.mfft, self.T)

    # ---- time/slice index algebra (scipy semantics) ----
    @property
    def delta_t(self) -> float:
        return self.T * self._hop

    @functools.cached_property
    def _pre_padding(self) -> tuple[int, int]:
        w2 = self._win ** 2
        n0 = -self.m_num_mid
        for p_, n_ in enumerate(range(n0, n0 - self.m_num - 1, -self._hop)):
            n_next = n_ - self._hop
            if n_next + self.m_num <= 0 or np.all(w2[n_next:] == 0):
                return n_, -p_
        raise RuntimeError("unreachable")

    @property
    def p_min(self) -> int:
        return self._pre_padding[1]

    @property
    def k_min(self) -> int:
        return self._pre_padding[0]

    @functools.lru_cache(maxsize=8)
    def _post_padding(self, n: int) -> tuple[int, int]:
        if n < self.m_num - self.m_num_mid:
            raise ValueError("n must be >= ceil(m_num/2)")
        w2 = self._win ** 2
        q1 = n // self._hop
        k1 = q1 * self._hop - self.m_num_mid
        for q_, k_ in enumerate(range(k1, n + self.m_num, self._hop),
                                start=q1):
            n_next = k_ + self._hop
            if n_next >= n or np.all(w2[:n - n_next] == 0):
                return k_ + self.m_num, q_ + 1
        raise RuntimeError("unreachable")

    def p_max(self, n: int) -> int:
        return self._post_padding(n)[1]

    def k_max(self, n: int) -> int:
        return self._post_padding(n)[0]

    def p_num(self, n: int) -> int:
        return self.p_max(n) - self.p_min

    @functools.cached_property
    def lower_border_end(self) -> tuple[int, int]:
        m0 = int(np.flatnonzero(self._win ** 2)[0])
        k0 = -self.m_num_mid + m0
        for q_, k_ in enumerate(range(k0, self._hop + 1, self._hop)):
            if k_ + self._hop >= 0:
                return k_ + self.m_num, q_ + 1
        return 0, max(self.p_min, 0)

    @functools.lru_cache(maxsize=8)
    def upper_border_begin(self, n: int) -> tuple[int, int]:
        w2 = self._win ** 2
        q2 = n // self._hop + 1
        q1 = max((n - self.m_num) // self._hop - 1, -1)
        for q_ in range(q2, q1, -1):
            k_ = q_ * self._hop + (self.m_num - self.m_num_mid)
            if k_ <= n or np.all(w2[n - k_:] == 0):
                return (q_ + 1) * self._hop - self.m_num_mid, q_ + 1
        return 0, 0

    def p_range(self, n: int, p0: int | None = None,
                p1: int | None = None) -> tuple[int, int]:
        p_max = self.p_max(n)
        p0_ = self.p_min if p0 is None else p0
        p1_ = p_max if p1 is None else p1
        if not (self.p_min <= p0_ < p1_ <= p_max):
            raise ValueError(
                f"invalid p0={p0}, p1={p1}: need {self.p_min} <= p0 < p1 "
                f"<= {p_max} for n={n}")
        return p0_, p1_

    def t(self, n: int, p0: int | None = None, p1: int | None = None,
          k_offset: int = 0):
        p0, p1 = self.p_range(n, p0, p1)
        return np.arange(p0, p1) * self.delta_t + k_offset * self.T

    def nearest_k_p(self, k: int, left: bool = True) -> int:
        p_q, remainder = divmod(k, self._hop)
        if remainder == 0:
            return k
        return p_q * self._hop if left else (p_q + 1) * self._hop

    # ---- the transforms ----
    @staticmethod
    def _pad_coeffs(n: int, k_start: int, k_end: int, padding: str, device):
        """scipy's border padding as a gather plan on ``device``:
        v[k] = c1 * x[i1] + c2 * x[i2] for k in [k_start, k_end); a factor
        or a second index that is None drops its term (c1 = 1, c2 = 0)."""
        if padding not in _PAD_MODES:
            raise ValueError(f"padding={padding!r} not in {_PAD_MODES}")
        k = torch.arange(k_start, k_end, device=device)
        i1 = k.clamp(0, n - 1)
        inside = (k >= 0) & (k < n)
        if padding == "zeros":
            return i1, inside.to(torch.float32), None, None
        if padding == "edge":
            return i1, None, None, None
        # reflection index (period 2n-2), numpy 'reflect' convention
        if n == 1:
            refl = torch.zeros_like(k)
        else:
            m = torch.remainder(k, 2 * n - 2)
            refl = torch.where(m < n, m, 2 * n - 2 - m)
        if padding == "even":
            return refl, None, None, None
        # odd: 2 x[edge] - x[reflection] outside, x itself inside
        inside = inside.to(torch.float32)
        return i1, 2.0 * (1.0 - inside), refl, 2.0 * inside - 1.0

    def _input_device(self, x):
        """Where non-tensor input goes (``device``, else the current CUDA
        device); None for a tensor or a pair of tensors, which stay where
        they are."""
        parts = x if is_pair(x) else (x,)
        if any(isinstance(v, torch.Tensor) for v in parts):
            return None
        return self.device or default_device()

    def _p_s(self) -> int:
        """The left roll of each mfft-padded frame that realises the
        phase shift (0 without one)."""
        if self.phase_shift is None:
            return 0
        return (self.phase_shift + self.m_num_mid) % self.m_num

    def _fft_frames(self, fr, fi):
        """FFT of windowed frames [..., P, m_num] (split; fi None for
        real) -> split [..., P, f_pts] per fft_mode/phase_shift."""
        mfft, m_num = self.mfft, self.m_num
        pad = (0, mfft - m_num)
        fr = torch.nn.functional.pad(fr, pad)
        if fi is not None:
            fi = torch.nn.functional.pad(fi, pad)
        p_s = self._p_s()
        if p_s:
            fr = torch.roll(fr, -p_s, -1)
            if fi is not None:
                fi = torch.roll(fi, -p_s, -1)
        if self.onesided_fft:
            if fi is not None:
                raise ValueError(
                    "complex input requires fft_mode 'twosided'/'centered'")
            if mfft % 2 == 0:
                Xr, Xi = rfft_last_split(fr, None)
            else:
                Xr, Xi = fftn_split(fr, torch.zeros_like(fr), (fr.ndim - 1,), FORWARD, None)
                Xr, Xi = Xr[..., :mfft // 2 + 1], Xi[..., :mfft // 2 + 1]
            if self.fft_mode == "onesided2X":
                mult = self._table("mult", fr.device)
                Xr, Xi = Xr * mult, Xi * mult
            return Xr, Xi
        Xr, Xi = fftn_split(fr, torch.zeros_like(fr) if fi is None else fi,
                            (fr.ndim - 1,), FORWARD, None)
        if self.fft_mode == "centered":
            Xr = torch.roll(Xr, mfft // 2, -1)
            Xi = torch.roll(Xi, mfft // 2, -1)
        return Xr, Xi

    def stft(self, x, p0: int | None = None, p1: int | None = None, *,
             k_offset: int = 0, padding: str = "zeros", axis: int = -1):
        """STFT of `x` along `axis`: complex64 output with the frequency
        axis at `axis`'s position and the time slices appended last."""
        is_c = _is_complex(x)
        if is_c and self.onesided_fft:
            raise ValueError(
                "complex input requires fft_mode 'twosided' or 'centered'")
        xr, xi = promote_to_split(x, self._input_device(x))
        if not is_c:
            xi = None
        n = xr.shape[axis]
        p0, p1 = self.p_range(n, p0, p1)
        mid = self.m_num_mid
        k_start = p0 * self._hop - mid + k_offset
        k_end = (p1 - 1) * self._hop - mid + self.m_num + k_offset
        i1, c1, i2, c2 = self._pad_coeffs(n, k_start, k_end, padding, xr.device)
        win = self._table("win", xr.device)
        num = p1 - p0

        def blend(v):
            v = v.movedim(axis, -1)
            out = v.index_select(-1, i1)
            if c1 is not None:
                out = out * c1
            if i2 is not None:
                out = out + v.index_select(-1, i2) * c2
            return out

        if (xi is None and self.onesided_fft and _on_card(xr)
                and cuda_welch.fused_welch_ok(k_end - k_start, self.m_num, self._hop,
                                              self.mfft, False)):
            # B20: framing, window, mfft pad, phase roll and R2C in one pass,
            # into complex64: no merge
            X = cuda_welch.spec_rfft_c64(blend(xr), win, self.m_num, self._hop, self.mfft,
                                         False, roll_s=self._p_s())
            if self.fft_mode == "onesided2X":
                X = X * self._table("mult", xr.device)
            ax = axis if axis >= 0 else X.ndim - 1 + axis
            return X.transpose(-1, -2).movedim(-2, ax)

        def prep(v):
            return _frame(blend(v), self.m_num, self._hop)[..., :num, :] * win

        Xr, Xi = self._fft_frames(prep(xr), None if xi is None else prep(xi))
        # [..., P, f] -> [..., f, P], f to `axis`'s position
        ax = axis if axis >= 0 else Xr.ndim - 1 + axis
        return merge(Xr.transpose(-1, -2).movedim(-2, ax),
                     Xi.transpose(-1, -2).movedim(-2, ax))

    def spectrogram(self, x, y=None, **kwargs):
        """abs(S)**2 of the STFT (or Sx * conj(Sy) when `y` is given)."""
        Sx = self.stft(x, **kwargs)
        if y is None:
            return Sx.real ** 2 + Sx.imag ** 2
        return Sx * self.stft(y, **kwargs).conj()

    def _ifft_frames(self, Xr, Xi):
        """Inverse of _fft_frames on [..., P, f_pts] -> [..., P, m_num]
        split (imag part is None for onesided)."""
        mfft, m_num = self.mfft, self.m_num
        if self.onesided_fft:
            if self.fft_mode == "onesided2X":
                imult = self._table("imult", Xr.device)
                Xr, Xi = Xr * imult, Xi * imult
            if mfft % 2 == 0:
                xr = irfft_last_split(Xr, Xi, mfft, 1.0 / mfft)
            else:
                # odd mfft: Hermitian-extend the half spectrum and run the
                # C2C inverse (the packed C2R is even-length only)
                Fr = torch.cat([Xr, Xr[..., 1:].flip(-1)], dim=-1)
                Fi = torch.cat([Xi, -Xi[..., 1:].flip(-1)], dim=-1)
                xr, _ = fftn_split(Fr, Fi, (Fr.ndim - 1,), INVERSE, 1.0 / mfft)
            xi = None
        else:
            if self.fft_mode == "centered":
                Xr = torch.roll(Xr, -(mfft // 2), -1)
                Xi = torch.roll(Xi, -(mfft // 2), -1)
            xr, xi = fftn_split(Xr, Xi, (Xr.ndim - 1,), INVERSE, 1.0 / mfft)
        p_s = self._p_s()
        if p_s:
            xr = torch.roll(xr, p_s, -1)
            if xi is not None:
                xi = torch.roll(xi, p_s, -1)
        return xr[..., :m_num], None if xi is None else xi[..., :m_num]

    def istft(self, S, k0: int = 0, k1: int | None = None, *,
              f_axis: int = -2, t_axis: int = -1):
        """Inverse STFT: reconstructs x[k0:k1] from slices assumed to
        start at p_min (scipy semantics).  Returns real float32 output for
        onesided modes, complex64 otherwise."""
        Sr, Si = promote_to_split(S, self._input_device(S))
        if f_axis == t_axis:
            raise ValueError("f_axis may not equal t_axis")
        if Sr.shape[f_axis] != self.f_pts:
            raise ValueError(f"S.shape[f_axis]={Sr.shape[f_axis]} must equal "
                             f"f_pts={self.f_pts}")
        n_min = self.m_num - self.m_num_mid
        if Sr.shape[t_axis] < self.p_num(n_min):
            raise ValueError("not enough time slices to invert")
        Sr = Sr.movedim((f_axis, t_axis), (-2, -1))
        Si = Si.movedim((f_axis, t_axis), (-2, -1))
        q_max = Sr.shape[-1] + self.p_min
        k_max = (q_max - 1) * self._hop + self.m_num - self.m_num_mid
        k1 = k_max if k1 is None else k1
        if not (self.k_min <= k0 < k1 <= k_max):
            raise ValueError(f"need k_min={self.k_min} <= k0={k0} < k1={k1}"
                             f" <= k_max={k_max}")
        if k1 - k0 < n_min:
            raise ValueError("k1 - k0 must be at least ceil(m_num/2)")
        dual = self._table("dual", Sr.device)
        base = self.p_min * self._hop - self.m_num_mid
        lo, hi = k0 - base, k1 - base
        fr, fi = self._ifft_frames(Sr.transpose(-1, -2), Si.transpose(-1, -2))
        q = fr.shape[-2]
        t = (q - 1) * self._hop + self.m_num
        xr = _ola_slabs(fr * dual, self._hop, t)[..., lo:hi]
        if fi is None:
            return xr
        return merge(xr, _ola_slabs(fi * dual, self._hop, t)[..., lo:hi])
