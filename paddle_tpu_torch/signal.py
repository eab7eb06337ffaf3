"""paddle.signal: ``frame``, ``overlap_add``, ``stft``, ``istft``: port
of ``paddle_tpu/signal.py``.

Framing is an index gather and overlap-add an ``index_add`` over the
output positions, both differentiable. The axis conventions are the
reference's (``signal.py:19-55``): ``[..., seq] -> [..., frame_length,
num_frames]`` for ``axis=-1``, ``[seq, ...] -> [num_frames,
frame_length, ...]`` for ``axis=0``. ``stft``'s centre padding takes
numpy's ``pad_mode`` names (``reflect``, ``constant``, ``edge``,
``symmetric``, ``wrap``), applied as an index gather.
"""
import numpy as np
import torch

from .core.tensor import Tensor, dispatch, unwrap

__all__ = ["frame", "overlap_add", "stft", "istft"]


def _frame_v(xv, frame_length, hop_length, axis):
    seq = xv.shape[axis]
    n_frames = 1 + (seq - frame_length) // hop_length
    idx = torch.as_tensor(
        np.arange(n_frames)[:, None] * hop_length
        + np.arange(frame_length)[None, :], device=xv.device)
    if axis in (-1, xv.dim() - 1):
        out = xv[..., idx]                      # [..., n_frames, frame_len]
        return out.transpose(-1, -2)            # [..., frame_len, n_frames]
    if axis == 0:
        return xv[idx]                          # [n_frames, frame_len, ...]
    raise ValueError("axis must be 0 or -1")


def _overlap_add_v(xv, hop_length, axis):
    if axis in (-1, xv.dim() - 1):
        frame_length, n_frames = xv.shape[-2], xv.shape[-1]
        frames = xv.transpose(-1, -2)           # [..., n_frames, frame_len]
    elif axis == 0:
        n_frames, frame_length = xv.shape[0], xv.shape[1]
        frames = torch.movedim(xv, (0, 1), (-2, -1))
    else:
        raise ValueError("axis must be 0 or -1")
    out_len = (n_frames - 1) * hop_length + frame_length
    pos = torch.as_tensor(
        (np.arange(n_frames)[:, None] * hop_length
         + np.arange(frame_length)[None, :]).reshape(-1), device=xv.device)
    flat = frames.reshape(frames.shape[:-2] + (-1,))
    out = torch.zeros(flat.shape[:-1] + (out_len,), dtype=flat.dtype,
                      device=flat.device).index_add(-1, pos, flat)
    if axis == 0 and xv.dim() > 2:
        out = torch.movedim(out, -1, 0)
    return out


def frame(x, frame_length, hop_length, axis=-1, name=None):
    """Slice into overlapping frames; the frame axis is added next to
    ``axis``."""
    if hop_length <= 0:
        raise ValueError("hop_length must be positive")
    xv = unwrap(x)
    seq = (xv.shape if torch.is_tensor(xv) else np.shape(xv))[axis]
    if frame_length > seq:
        raise ValueError(f"frame_length ({frame_length}) > sequence length "
                         f"({seq})")
    return dispatch(lambda v: _frame_v(v, frame_length, hop_length, axis),
                    x, name="frame")


def overlap_add(x, hop_length, axis=-1, name=None):
    """The inverse of ``frame``: overlapping frames summed back into a
    signal."""
    return dispatch(lambda v: _overlap_add_v(v, hop_length, axis), x,
                    name="overlap_add")


def _window(win_in, win_length, n_fft, dtype, device):
    win = torch.ones(win_length, dtype=dtype, device=device) \
        if win_in is None else torch.as_tensor(win_in).to(device=device,
                                                           dtype=dtype)
    if win_length < n_fft:
        lp = (n_fft - win_length) // 2
        win = torch.nn.functional.pad(win, (lp, n_fft - win_length - lp))
    return win


def _pad_signal(xv, p, mode):
    """numpy's ``np.pad(x, [(0, 0), (p, p)], mode)`` on the last axis."""
    T = xv.shape[-1]
    if mode == "constant":
        return torch.nn.functional.pad(xv, (p, p))
    idx = torch.as_tensor(np.pad(np.arange(T), (p, p), mode=mode),
                          device=xv.device)
    return xv[..., idx]


def _win_arg(window):
    return None if window is None else (
        unwrap(window) if isinstance(window, Tensor) else window)


def stft(x, n_fft, hop_length=None, win_length=None, window=None,
         center=True, pad_mode="reflect", normalized=False, onesided=True,
         name=None):
    """``[B, T]`` (or ``[T]``) -> complex ``[B, n_fft // 2 + 1,
    n_frames]`` (``n_fft`` bins when not ``onesided``)."""
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft
    win_in = _win_arg(window)

    def fn(xv):
        squeeze = xv.dim() == 1
        if squeeze:
            xv = xv[None]
        win = _window(win_in, win_length, n_fft, xv.dtype, xv.device)
        if center:
            xv = _pad_signal(xv, n_fft // 2, pad_mode)
        frames = _frame_v(xv, n_fft, hop_length, -1)     # [B, n_fft, F]
        frames = frames.transpose(-1, -2) * win          # [B, F, n_fft]
        spec = torch.fft.rfft(frames, dim=-1) if onesided else \
            torch.fft.fft(frames, dim=-1)
        if normalized:
            spec = spec / torch.sqrt(torch.tensor(
                float(n_fft), dtype=spec.real.dtype, device=spec.device))
        out = spec.transpose(-1, -2)                     # [B, bins, F]
        return out[0] if squeeze else out

    return dispatch(fn, x, name="stft")


def istft(x, n_fft, hop_length=None, win_length=None, window=None,
          center=True, normalized=False, onesided=True, length=None,
          return_complex=False, name=None):
    """The inverse STFT, normalised by the window's overlap-added
    envelope."""
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft
    win_in = _win_arg(window)

    def fn(xv):
        squeeze = xv.dim() == 2
        if squeeze:
            xv = xv[None]
        win = _window(win_in, win_length, n_fft, torch.float32, xv.device)
        spec = xv.transpose(-1, -2)                      # [B, F, bins]
        if normalized:
            spec = spec * torch.sqrt(torch.tensor(
                float(n_fft), dtype=torch.float32, device=xv.device))
        frames = torch.fft.irfft(spec, n=n_fft, dim=-1) if onesided else \
            torch.fft.ifft(spec, dim=-1).real            # [B, F, n_fft]
        frames = frames * win
        sig = _overlap_add_v(frames.transpose(-1, -2), hop_length, -1)
        env = _overlap_add_v(
            (win * win)[:, None].expand(n_fft, frames.shape[1]),
            hop_length, -1)
        sig = sig / env.clamp_min(1e-11)
        if center:
            sig = sig[..., n_fft // 2:]
            if length is None:
                sig = sig[..., :sig.shape[-1] - n_fft // 2]
        if length is not None:
            sig = sig[..., :length]
        return sig[0] if squeeze else sig

    return dispatch(fn, x, name="istft")
