"""FrameSpec: every static constant of one modem configuration, built once.

Counterpart of ``c_ofdm_tpu/models/frame.py``.  The JAX package keeps numpy
constants that XLA bakes into each executable.  Here the same numpy constants
are kept, and the device constants derived from them (DFT bases incl. the
hop track's half-block basis and sign, Toeplitz band, the matched filter's
spectrum at each FFT size it takes, conjugated preamble, preamble points,
and the partial-DFT bases and pilot waveform of the backends that read
them) are built once per (spec, device, dtype) and held as tensors in
``FrameSpec.tensors``; ``models.modem.FlagshipStep`` and
``models.streaming.StreamingReceiver`` register them as buffers.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ..config import ModemConfig
from ..oracle import reference as oracle
from ..ops import cfo, chanest, fft, sync
from ..ops.modulation import real_dtype

# the numpy constants a FrameSpec carries; the "weights" a JAX FrameSpec
# hands to ``frame_spec_from_arrays``
ARRAY_FIELDS = ("pilot_bins", "data_bins", "t2_mask", "t2_burst",
                "preamble_time", "preamble_points", "matched_filter",
                "cfo_borders", "cfo_window_mask")


@dataclasses.dataclass(frozen=True, eq=False)
class FrameSpec:
    cfg: ModemConfig
    dtype: torch.dtype              # complex64 | complex128
    # subcarrier maps
    pilot_bins: np.ndarray          # [P] int32
    data_bins: np.ndarray           # [D] int32 (segment order)
    # constants
    t2_mask: np.ndarray             # [t2sin_size] float
    t2_burst: np.ndarray            # [t2sin_size] complex
    preamble_time: np.ndarray       # [preamble_len] complex (incl CP)
    preamble_points: np.ndarray     # [num_pr_symb * num_data_subc] complex
    matched_filter: np.ndarray      # [pr_sin_len] complex, unit norm, conjugated
    cfo_borders: np.ndarray         # [num_pilot_subc+2] int, pilot windows after fftshift
    cfo_window_mask: np.ndarray     # [num_pilot_subc+1] bool, True = use window
    tensors: Dict[str, torch.Tensor]  # device constants, see _build_tensors
    structured: bool                # canonical segment bin layout (slices,
    #                                 not gathers, on the full-spectrum path)
    fft_backend: str = "matmul"     # ops/fft.py BACKENDS (the JAX default
    #                                 is "xla")

    @property
    def device(self) -> torch.device:
        return self.tensors["pre_conj"].device

    @property
    def real_dtype(self) -> torch.dtype:
        return real_dtype(self.dtype)

    @property
    def cfo_segments(self):
        """[(lo, hi)) pilot-peak search windows of ``ops.cfo``."""
        return cfo._cfo_window_segments(self.cfo_borders, self.cfo_window_mask)

    def with_tensors(self, tensors: Dict[str, torch.Tensor]) -> "FrameSpec":
        """The same spec reading its device constants from ``tensors``
        (e.g. an nn.Module's buffers after ``.to(device)``)."""
        missing = set(self.tensors) - set(tensors)
        if missing:
            raise KeyError(f"with_tensors: missing {sorted(missing)}")
        return dataclasses.replace(
            self, tensors={k: tensors[k] for k in self.tensors})


def _cfo_borders(cfg: ModemConfig):
    """Pilot-peak search windows in the fftshifted preamble spectrum
    (`OFDM/Frame.hpp:311-322`, with the out-of-bounds write replaced by a
    clamp of the true last border)."""
    size = cfg.preamble_len
    rel_bw = (cfg.num_data_subc + cfg.num_pilot_subc) / cfg.fft_size
    rel_pw = rel_bw / cfg.num_pilot_subc
    pw = int(size * rel_pw)
    j0 = int((1.0 - rel_bw - rel_pw) / 2.0 * size)
    borders = j0 + pw * np.arange(cfg.num_pilot_subc + 2)
    borders[0] = max(0, borders[0])
    borders[-1] = min(size, borders[-1])
    mask = np.ones(cfg.num_pilot_subc + 1, dtype=bool)
    mask[cfg.num_pilot_subc // 2] = False   # skip the DC window
    return borders, mask


def _build_tensors(cfg: ModemConfig, arrays: Dict[str, np.ndarray],
                   device: torch.device, dtype: torch.dtype,
                   fft_backend: str) -> Dict[str, torch.Tensor]:
    """Every device constant the batch and streaming receivers read under
    ``fft_backend``, each rounded once from its float64 numpy value to the
    working precision (or, for wideband matmul bases, built on the device by
    ``fft.dft_basis``).  The partial-DFT bases are built only for the
    backends that read them: ``rx_basis``, ``tx_basis`` and
    ``tx_pilot_time`` for the matmul backends, ``cfo_basis`` where
    ``cfo.uses_partial_spectrum`` takes the product; the bin gathers
    (``pilot_idx``, ``data_idx``, ``tx_bin_src``) for the other backends on
    a layout that is not the canonical one.  The coarse CFO's window index
    ``cfo_win_idx`` points into whichever spectrum that rule makes.  No
    step makes a constant from host data while it runs: a CUDA-graph
    capture refuses the host-to-device copy (see ``utils/graphs.py``)."""
    rdt = real_dtype(dtype)

    def pair(w):
        return fft.basis_pair(w, device, rdt)

    def cplx(a):
        return torch.from_numpy(np.asarray(a, dtype=np.complex128)).to(
            device=device, dtype=dtype)

    def real(a):
        return torch.from_numpy(np.asarray(a, dtype=np.float64)).to(
            device=device, dtype=rdt)

    segs = cfo._cfo_window_segments(arrays["cfo_borders"],
                                    arrays["cfo_window_mask"])
    partial = cfo.uses_partial_spectrum(
        fft_backend, cfg.preamble_len, sum(hi - lo for lo, hi in segs))
    _, t2_weights = sync._t2_masked_bins(arrays["t2_mask"])
    chan_i, chan_k = chanest._chan_index_np(cfg.num_data_subc)
    hop_basis, hop_sign = sync._t2_hop_np(arrays["t2_mask"])
    tensors = {
        "t2_basis": pair(sync._t2_basis_np(arrays["t2_mask"])),
        "t2_weights": real(t2_weights),
        "t2_hop_basis": pair(hop_basis),
        "t2_hop_sign": real(hop_sign),
        "mf_band": pair(sync._toeplitz_mf_np(arrays["matched_filter"],
                                             cfg.pr_sin_len)),
        **{sync.mf_spectrum_key(m): cplx(sync._mf_spectrum_np(
            arrays["matched_filter"], m))
           for m in sync.mf_spectrum_sizes(cfg.pr_sin_len)},
        "t2_mask": real(arrays["t2_mask"]),
        "cfo_lo": torch.tensor([lo for lo, _ in segs], dtype=torch.int64,
                               device=device),
        "cfo_win_idx": torch.from_numpy(cfo.cfo_window_index(
            segs, cfg.preamble_len, partial)).to(device),
        "t2_burst": cplx(arrays["t2_burst"]),
        "preamble_time": cplx(arrays["preamble_time"]),
        "pre_conj": cplx(np.conj(arrays["preamble_time"])),
        "pre_points": cplx(arrays["preamble_points"]),
        "chan_i": real(chan_i),
        "chan_k": real(chan_k),
    }
    if partial:
        tensors["cfo_basis"] = cfo.cfo_basis(cfg.preamble_len, segs, device,
                                             rdt)
    if fft_backend not in fft.MATMUL_BACKENDS and not \
            chanest.layout_is_structured(cfg, arrays["pilot_bins"],
                                         arrays["data_bins"]):
        def index(a):
            return torch.from_numpy(np.asarray(a, dtype=np.int64)).to(device)
        tensors["pilot_idx"] = index(arrays["pilot_bins"])
        tensors["data_idx"] = index(arrays["data_bins"])
        tensors["tx_bin_src"] = index(chanest.tx_bin_maps_np(
            cfg, arrays["pilot_bins"], arrays["data_bins"]))
    if fft_backend in fft.MATMUL_BACKENDS:
        tensors["rx_basis"] = chanest.rx_basis(
            cfg, arrays["pilot_bins"], arrays["data_bins"], device, rdt)
        tx_w, tx_pilot = chanest.tx_basis(
            cfg, arrays["pilot_bins"], arrays["data_bins"], device, rdt)
        tensors["tx_basis"] = tx_w
        tensors["tx_pilot_time"] = cplx(tx_pilot)
    return tensors


def _spec(cfg: ModemConfig, arrays: Dict[str, np.ndarray], device, dtype,
          fft_backend: str) -> FrameSpec:
    fft.check_backend(fft_backend)
    if dtype not in (torch.complex64, torch.complex128):
        raise ValueError(f"dtype must be complex64 or complex128, got {dtype}")
    device = torch.device(device)
    if device.type == "cuda":
        # the DFT products need full float32 (the JAX package's f32 matmul
        # semantics); TF32 keeps ~3 decimal digits
        torch.backends.cuda.matmul.allow_tf32 = False
    arrays = {k: np.asarray(arrays[k]) for k in ARRAY_FIELDS}
    return FrameSpec(
        cfg=cfg, dtype=dtype, fft_backend=fft_backend,
        tensors=_build_tensors(cfg, arrays, device, dtype, fft_backend),
        structured=chanest.layout_is_structured(
            cfg, arrays["pilot_bins"], arrays["data_bins"]),
        **arrays)


def make_frame_spec(cfg: ModemConfig = None, dtype=torch.complex64, *,
                    device, fft_backend: str = "matmul") -> FrameSpec:
    """Build a spec from a config, its numpy constants computed by the
    port's own ``oracle.reference``.  ``device`` is required: there is no
    implicit default device.  ``fft_backend`` is one of ``ops.fft.BACKENDS``
    (ValueError otherwise); its default here is "matmul", where the JAX
    package's is "xla"."""
    cfg = cfg or ModemConfig()
    pilots, data_bins = oracle.subcarrier_maps(cfg)
    borders, wmask = _cfo_borders(cfg)
    arrays = dict(
        pilot_bins=pilots.astype(np.int32),
        data_bins=data_bins.astype(np.int32),
        t2_mask=oracle.t2_detect_mask(cfg),
        t2_burst=oracle.t2sin_burst(cfg),
        preamble_time=oracle.preamble_time(cfg),
        preamble_points=oracle.preamble_points(cfg),
        matched_filter=oracle.matched_filter(cfg),
        cfo_borders=borders,
        cfo_window_mask=wmask,
    )
    return _spec(cfg, arrays, device, dtype, fft_backend)


def frame_spec_from_arrays(cfg_fields: dict, arrays: Dict[str, np.ndarray],
                           device, dtype=torch.complex64,
                           fft_backend: str = "matmul") -> FrameSpec:
    """Build a spec from another package's constants: ``cfg_fields`` is
    ``dataclasses.asdict`` of a ModemConfig and ``arrays`` holds the numpy
    fields named in ARRAY_FIELDS (e.g. taken from a JAX FrameSpec).  The
    device constants are derived from these arrays, not recomputed."""
    return _spec(ModemConfig(**cfg_fields), arrays, device, dtype,
                 fft_backend)
