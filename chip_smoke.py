"""Quickest proof that the PyTorch port (c_ofdm_tpu_torch) runs on a GPU.

    python3 chip_smoke.py [--profile FILE]

Needs one CUDA device and nvcc (on PATH or under $CUDA_HOME/bin).  Drives
the port's paths, complex64: the flagship step (payload -> transmit ->
receive_batch, B = 256 frames, ``FlagshipStep``, stock ModemConfig) under
the matmul backend, under pallas (K4, the DFT kernel) and under xla,
matmul_bf16, ct and ct_bf16; the wideband 8k-QAM64 step under ct (B = 128
frames of 27 904 samples, bench.py's wideband geometry); and the streaming
receiver (``StreamingReceiver``, gated sync on the 41-frame ring of
246 656 samples, S = 4 consecutive buffers at C = 1, 8 and 64 channels,
and C = 8 under pallas); and the MAC-framed link loop (``Mac``, the channel
simulator ``apply_channel``, the batch and streaming receivers); and the
command-line apps (``tx``, ``rx``, ``loopback``, ``ber-sweep``,
``ingest-bench``, ``scaling-bench``); and ``parallel/``, the sharded
receiver and the channel-sharded stream in worlds of ranks.  Phases, each printing its lines:

  1 device    the card, its name and power limit (nvidia-smi)
  2 build     csrc/extract_windows.cu (K1, K2, K3: the wide and scalar
              bodies, and the empty kernel) and csrc/dft.cu (K4's radix and
              dense routes), one nvcc each for sm_90a, started together;
              ptxas registers and spills of every instantiation
  3 kernel    K1 against its plain PyTorch version, bit for bit
  4 clean     B = 256 payloads decode exactly, one K1 launch per step
  5 impaired  B = 256 frames at random offsets with CFO and 30 dB AWGN plus
              4 all-zero rows: exact payloads and positions, and the same
              result as the port's plain CPU run
  6 timing    the step (CUDA events) and its device time and idle share,
              K1 against the plain gather and the library call (an index
              into the unfolded view; device time, torch.profiler)
  7 ring      K2 and K3 against their plain versions, bit for bit, at the
              streaming shapes, complex128, negative and past-end starts
  8 stream    rings built as bench.py builds them (fill 0.8, random gaps,
              CFO 1e-4, amplitude 60, 26 dB AWGN), C = 1/8/64: every planted
              frame decodes exactly once, in order, at its planted start,
              with exact bytes; K2 (C = 1) or K3 (C > 1) launched twice per
              buffer, each launch in the class its shape names, K1 never
  9 stream-cpu  C = 1 and 8: every output field equal to the port's CPU run
 10 state     save_state/load_state after buffer 2 resumes identically
 11 no-sync   one C = 8 buffer under torch.cuda.set_sync_debug_mode("error"),
              eager (process_buffer) and as the receiver's graph replay
 12 stream-timing  per-buffer median (CUDA events), samples/s, device time
              and idle share at C = 1/8/64; K2/K3 against their plain
              versions and the library call at the path's shapes (device
              time, torch.profiler)
 13 pallas-stream  the C = 8 buffers of phase 8 under pallas: every planted
              frame exact, K4 once (radix route) and K3 twice per buffer;
              per-buffer time
 14 dft       K4 against dft_ref and the float64 DFT: the step's two shapes
              (the RX input as the strided CP-stripped view), n = 256 with
              scale 1/sqrt(n), ragged [1000, 512], leading dims (2, 3, 256),
              n = 500 (dense route), n = 64, 1024 scaled and 8192; error
              <= 1e-5 max|Y| and <= 4x the plain version's; radix cases
              also within 1e-6 max|Y| of dft_radix_ref; the route each took
 15 pallas    the flagship step under pallas, B = 256: clean payloads exact
              with K4 launched 2 times (both radix) and K1 once per step;
              phase 5's impaired captures exact at their planted offsets;
              sync and bytes equal to the port's CPU run; step timing
 16 backends  the step under xla, matmul_bf16, ct and ct_bf16: clean
              payloads exact, K4 never launched; step median
 17 wideband  the 8k-QAM64 step under ct, B = 128: clean payloads exact;
              random offsets in [0, 4096], CFO 1e-5, amplitude 10, 30 dB
              decode exactly at their offsets; 4 rows equal to the CPU run;
              step timing
 18 dft-timing  K4 at the step's two shapes: device time beside its bound
              (a DFT's bytes and FFT operations), dft_radix_ref, the plain
              version, torch.fft (the library call) and complex torch.matmul
              with the cached W (torch.profiler), with the L2 warm (one
              input) and cold (12 inputs in turn); the same for the pallas
              streaming buffer's one launch, [2952, 512]; the dense route
              once at [2304, 500]
 19 gather-timing  the card's floor per launch (an empty kernel on grids
              (1), (49, 4) and (41, 23) and on the C = 1 path's own two);
              then, in turns within this one call, the scalar body, the
              wide body and the library call:
              K2's two launches each on its own line, with the L2 warm (one
              ring) and cold (40 rings in turn), K3 at C = 8 and 64, K1 at
              [256, 6016] and [128, 32000]; each beside its byte bound, the
              class the path runs and the fastest body; K2's frame windows
              at all-even and all-odd starts

 20 mac       the MAC codec at B = 256 for spread = mod_type 1, 2, 4, 6, 8
              at each config's frame_bytes, crc on and off: write equal to
              the CPU run and read back; read_bytes, read_soft and read_llr
              of noisy inputs equal to the CPU run in every field; crc16
              against the table walk in numpy on random lengths; one write
              and one read_soft under set_sync_debug_mode("error"); CUDA
              kernels and device time per call of write, read_soft, crc16
              and the rejected byte-serial table walk (torch.profiler)
 21 link-batch  B = 256 payloads -> Mac.write -> transmit -> apply_channel
              (four sets of 64 frames: the channels of
              tests/test_mac_channel.py:64-103, noise from a generator on the
              card) -> receive_batch -> read_soft: every frame at its set's
              timing offset, payloads and seq exact, CRC valid, K1 once;
              read_llr(soft_llrs) the same; one set with phi0 and noise
              drawn on the CPU equal to the port's CPU run; apply_channel's
              device time at [64, capture]
 22 link-stream  bench.py's MAC-framed rings (Mac.write, fill 0.8, random
              gaps, CFO 1e-4, amplitude 60, 26 dB) at C = 1 and 8, S = 4
              buffers: every planted frame decoded exactly once, in order, at
              its planted start, read_soft of every valid slot gives seq and
              payload exact with the CRC valid, K2 (C = 1) or K3 (C = 8)
              twice per buffer; then the +-20 ppm sample-clock stream of
              tests/test_mac_channel.py:106-142 through apply_channel on the
              card: all 12 frames CRC-clean, in order
 23 apps      the CLI (python -m c_ofdm_tpu_torch ...) on the card, each
              app's main(argv) in-process: tx of a 1200-byte payload (gap
              500) -> rx with --log, --metrics, --summary-json: the payload
              decoded, every row CRC-clean with consecutive seq, K2 twice
              per buffer; --drain metadata at --chunk 1 and 2 tallies what
              the full drain decoded, --out empty; --native-ingest equal to
              rx of the file its looping replay yields; the card equal to a
              --device cpu run; a tx-written stream of 20 stock buffers
              (738 frames, 19.2 MB of int16) decoded exactly, with
              steady_samples_per_s, host_feed_s and device_drain_s printed
              beside the card's name and power limit, then the same run
              under torch.profiler: device time and kernels per buffer, and
              the device's idle share of the first run's wall; loopback at 28 dB in
              complex64 and --f64: ACCURACY: 1.0, exit 0, K1 once per call;
              ber-sweep --mods 4 --snrs 12:29:8 --frames 4: BER 0 at 28 dB,
              EVM falling with SNR; ingest-bench --buffers 50 --to-device
 24 parallel  parallel/ on the card: (a) a world of one (an NCCL group of
              size 1 in this process): the sharded receiver at C = 8 x
              240 640 on __graft_entry__.py's dryrun capture (CFO 1e-4,
              30 dB, random gaps, amplitudes 40 x 0.6-1.0, a near-gate
              spurious burst per channel): every frame once at start +
              t2sin_size, bytes exact, CRC valid, equal to the CPU run, K3
              twice and K1, K2, K4 never; time per call (CUDA events) and
              device time; once more under pallas, K4 once; (b) 4 gloo
              ranks all on cuda:0 (parallel/launch.py), mesh {channel: 2,
              time: 2}, the halo staged through host memory: the dryrun
              capture with a frame straddling the time boundary and one
              ending at the capture end per channel, equal to the truth and
              to process_buffer over the whole capture; (c) the
              channel-sharded stream, 2 gloo ranks on cuda:0: phase 22's
              C = 8 rings, S = 4, equal to StreamingReceiver(channels=8);
              (d) scaling-bench --devices 1 --channels 8 --frames-per-block
              40 in-process, then --devices 2 raising the mesh's ValueError

 25 compiled  the JAX package's compiled entry points as CUDA-graph
              replays (utils/graphs.py), each against the same code run
              eagerly on the same inputs (the captured calls made to run
              their steps kernel by kernel): FlagshipStep at B = 256 under
              matmul (K1; also transmit_jit -> receive_batch_jit) and pallas
              (K1 + 2 K4), the wideband step at B = 128 under ct (K1 wide);
              StreamingReceiver on phase 8's rings, S = 4, gated, at C = 1
              (K2 twice), 8 and 64 (K3 twice), and C = 8 under pallas (K3
              twice + K4); the rx CLI on phase 23's 20-buffer stream, full
              drain, --drain metadata and --chunk 4.  Per cell: bytes,
              positions, valid, found, num_found and the state's
              next_min_pos and frames_seen exactly equal, the float fields'
              max difference printed; K1-K4 launches per replay equal to
              per eager call, and torch.profiler sees each kernel they name
              as often per replay; eager and graph in turns: wall per call
              (CUDA events), device time, idle share, capture seconds, the
              graph pool's memory and the copy launches around a replay

Then one JSON line describing the kernels, and last one JSON line
``{"ok": true, "device": {...}}``.  Any failed phase raises: the script
exits non-zero and prints no result.  ``--profile FILE`` also writes a
torch.profiler table of 10 flagship steps to FILE, one of 10 streaming
buffers at each C to FILE.stream_c<C>, and one of 10 steps each of the
pallas and wideband steps to FILE.pallas and FILE.wideband.
"""

import argparse
import contextlib
import io
import itertools
import json
import math
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch

B = 256            # frames per step (bench.py's flagship batch)
B_WIDE = 128       # wideband frames per step (bench.py::bench_wideband)
EXTRA_WIDE = 4096  # wideband captures are frame_len + EXTRA_WIDE samples
WIDEBAND = dict(fft_size=8192, num_data_subc=4096, num_pilot_subc=32,
                cp_size=1024, num_symb=2, pr_sin_len=512, mod_type=6)
OTHER_BACKENDS = ("xla", "matmul_bf16", "ct", "ct_bf16")
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 non-tensor FLOP/s
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
L2_BYTES = 50e6
# the radix K4 against dft_radix_ref: the same passes and twiddles, each
# butterfly rounded in its own order (a few float32 ulps of max|Y| per pass)
RADIX_REF_TOL = 1e-6
COLD_SETS = 12     # input sets per shape in phase 18's cold-L2 timing
EXTRA = 1024       # impaired captures are frame_len + EXTRA samples
ZERO_ROWS = 4
SEED = 0
S = 4              # consecutive streaming buffers per channel count
CHANNELS = (1, 8, 64)
CPU_CHANNELS = (1, 8)
STATE_C = 8        # channel count of the state and no-sync phases


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, reps):
    """Per-call milliseconds of fn() over reps back-to-back calls, by CUDA
    events around the whole run."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for i in range(reps):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps, tries=3):
    """(device milliseconds per call, profiler events) over reps calls of
    fn(i): the sum of the CUDA kernel times torch.profiler records.  A
    session that records no device time (seen once right after a long
    profiled window) is repeated, up to ``tries`` sessions."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(reps):
                fn(i)
            torch.cuda.synchronize()
        events = prof.key_averages()
        us = sum(e.self_device_time_total for e in events
                 if e.device_type == DeviceType.CUDA)
        if us > 0:
            return us / 1e3 / reps, events
    raise RuntimeError(f"chip_smoke: torch.profiler recorded no device time "
                       f"in {tries} sessions")


def phase_device():
    check(torch.cuda.is_available(),
          "torch.cuda.is_available() is False: this check runs on a CUDA "
          "device only")
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # full-float32 DFT products (the JAX package's f32 matmul semantics)
    torch.backends.cuda.matmul.allow_tf32 = False
    say("device", f"{torch.cuda.get_device_name(0)} (count "
        f"{torch.cuda.device_count()}), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, allow_tf32=False")
    print(smi, flush=True)
    return dev, smi


def phase_build():
    """Phase 2: one nvcc per kernel source, started together."""
    from concurrent.futures import ThreadPoolExecutor
    from c_ofdm_tpu_torch.ops import _kernels, dft, extract
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(extract._lib), pool.submit(dft._lib)]:
            f.result()
    secs = time.perf_counter() - t0
    for name, ids in (("extract_windows", "K1-K3"), ("dft", "K4")):
        lib = _kernels.library_path(name)
        log = lib.with_suffix(".log")
        say("build", f"{ids}: {lib.name}")
        for ln in (log.read_text().splitlines() if log.exists() else []):
            if ("registers" in ln or "spill" in ln
                    or "Compiling entry function" in ln):
                say("build", f"{ids} ptxas: {ln.strip()}")
    say("build", f"both built and loaded in {secs:.2f} s")


def bytes_ms(nbytes):
    return nbytes / HBM_BYTES_S * 1e3


def library_gather(x, starts, win):
    """The one PyTorch call that computes what K1 (x [B, n], starts [B]), K2
    (x [n], starts [K]) or K3 (x [C, n], starts [C, K]) computes, for starts
    already in [0, n - win]: an index into the unfolded view.  Returns a
    function of the call number; the index tensors are made here, outside
    the timed call.  The port never calls it: it is the kernels' yardstick."""
    idx = starts.long()
    if x.dim() == 2:
        rows = torch.arange(x.shape[0], device=x.device)
        idx = (rows, idx) if idx.dim() == 1 else (rows[:, None], idx)
    return lambda i: x.unfold(-1, win, 1)[idx]


def _kernel_cases(dev):
    """(label, captures, starts, win) at the shapes the main path gives K1,
    a ragged multi-frame shape, and complex128."""
    from c_ofdm_tpu_torch import ModemConfig
    cfg = ModemConfig()
    win = cfg.preamble_len + cfg.message_len
    g = torch.Generator(device=dev).manual_seed(SEED)
    rng = np.random.default_rng(SEED)

    def caps(rows, n, dtype):
        return torch.randn(rows, n, dtype=dtype, device=dev, generator=g)

    def st(values):
        return torch.tensor(np.asarray(values), dtype=torch.int32, device=dev)

    n3 = 3 * cfg.frame_len
    return [
        ("main c64", caps(B, cfg.frame_len, torch.complex64),
         st(rng.integers(0, cfg.frame_len - win + 1, B)), win),
        ("ragged c64", caps(5, n3, torch.complex64),
         st([0, 100, cfg.frame_len, 2 * cfg.frame_len, n3 - win]), win),
        ("small c128", caps(7, 1000, torch.complex128),
         st([-3, 0, 1, 350, 699, 700, 10**6]), 300),
    ]


def run_kernel_checks(dev):
    from c_ofdm_tpu_torch.ops import extract
    worst = 0.0
    for label, x, s, win in _kernel_cases(dev):
        got = extract.extract_windows(x, s, win)
        want = extract.extract_windows_ref(x, s, win)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        worst = max(worst, err)
        check(torch.equal(got, want),
              f"K1 differs from extract_windows_ref on {label} "
              f"(max abs err {err})")
        say("kernel", f"{label} {tuple(x.shape)} win={win}: bit-exact "
            f"(max abs err {err})")
    return worst


def run_ring_kernel_checks(dev):
    """Phase 7: K2 and K3 bit-exact against their plain versions on the
    stock ring at the streaming path's (K, win) pairs, C = 8 and 64, a
    complex128 case, and negative and past-end starts.  Returns the worst
    absolute error of each kernel."""
    from c_ofdm_tpu_torch import ModemConfig
    from c_ofdm_tpu_torch.ops import extract
    cfg = ModemConfig()
    n = (cfg.rx_buf_size + 1) * cfg.frame_len
    sig = cfg.preamble_len + cfg.message_len
    K = cfg.rx_buf_size + 1
    pairs = ((K + cfg.t2_gate_slack, cfg.gated_search_lags + cfg.pr_sin_len),
             (K, sig))
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    rng = np.random.default_rng(SEED + 2)
    worst = {"single": 0.0, "multi": 0.0}
    for C, dtype in ((1, torch.complex64), (8, torch.complex64),
                     (64, torch.complex64), (3, torch.complex128)):
        rings = torch.randn(C, n, dtype=dtype, device=dev, generator=g)
        for k, win in pairs:
            st = rng.integers(0, n - win + 1, (C, k))
            st[:, :7] = [-n - 5, -7, -1, 0, n - win, n - win + 1, 10**6]
            st = torch.tensor(st, dtype=torch.int32, device=dev)
            cases = [("multi", extract.extract_windows_multi,
                      extract.extract_windows_multi_ref, rings, st)]
            if C in (1, 3):
                cases.append(("single", extract.extract_windows_single,
                              extract.extract_windows_single_ref, rings[0],
                              st[0]))
            for name, fn, ref, x, s in cases:
                got, want = fn(x, s, win), ref(x, s, win)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                worst[name] = max(worst[name], err)
                check(torch.equal(got, want),
                      f"K{2 if name == 'single' else 3} differs from its "
                      f"plain version at C={C} K={k} win={win} {dtype} "
                      f"(max abs err {err})")
                say("ring", f"{'K2' if name == 'single' else 'K3'} "
                    f"{tuple(x.shape)} {str(dtype)[6:]} K={k} win={win}: "
                    f"bit-exact (max abs err {err})")
    return worst


def streaming_buffers(spec, C, seed, mac=None):
    """S consecutive ingest buffers per channel, made on the spec's device
    as bench.py::_make_rings_cpu makes them: int(0.8 * S * buf / frame_len)
    frames per channel at multinomial random gaps, CFO 1e-4 cycles/sample,
    amplitude 60, AWGN at 26 dB SNR.  The frames carry random frame_bytes
    payloads, or with ``mac`` (bench.py's ``Mac(frame_bytes,
    spread=mod_type)``) random mac.payload bytes written by ``mac.write``
    with seq 0, 1, ... per channel (``transmit`` either way).  Returns
    (blocks [S, C, buf] complex64, or [S, buf] at C = 1; per channel the
    planted (start, frame bytes) of each frame that fits in the S buffers,
    in order; the payloads [C, frames, bytes] as drawn)."""
    from c_ofdm_tpu_torch.models import tx
    cfg = spec.cfg
    dev = spec.device
    buf = cfg.rx_buf_size * cfg.frame_len
    total = S * buf
    rng = np.random.default_rng(seed)
    nf = int(0.8 * total / cfg.frame_len)
    width = mac.payload if mac else cfg.frame_bytes
    payload = rng.integers(0, 256, (C, nf, width), dtype=np.uint8)
    gaps = np.stack([rng.multinomial(total - nf * cfg.frame_len,
                                     np.ones(nf + 1) / (nf + 1))
                     for _ in range(C)])
    starts = np.cumsum(gaps[:, :nf], axis=1) + cfg.frame_len * np.arange(nf)
    wire = torch.from_numpy(payload).to(dev)
    if mac:
        wire = mac.write(wire, torch.arange(nf, device=dev))
    frames = tx.transmit(spec, wire)
    wire = wire.cpu().numpy()
    flat = torch.from_numpy(starts + total * np.arange(C)[:, None]).to(dev)
    idx = flat[..., None] + torch.arange(cfg.frame_len, device=dev)
    sig = torch.zeros(C * total, dtype=torch.complex64, device=dev)
    sig[idx.reshape(-1)] = frames.reshape(-1)
    k = torch.arange(total, dtype=torch.float64, device=dev)
    rot = torch.polar(torch.full_like(k, 60.0), 2 * np.pi * 1e-4 * k)
    std = torch.sqrt((frames.abs() ** 2).mean() * 3600
                     * 10 ** (-26.0 / 10) / 2)
    g = torch.Generator(device=dev).manual_seed(seed)
    noise = torch.randn((2, C, total), generator=g, device=dev)
    sig = (sig.view(C, total) * rot.to(torch.complex64)
           + torch.complex(noise[0], noise[1]) * std)
    blocks = sig.view(C, S, buf).transpose(0, 1).contiguous()
    truth = [[(int(s), wire[c, i]) for i, s in enumerate(starts[c])
              if s + cfg.frame_len < total] for c in range(C)]
    return (blocks[:, 0].contiguous() if C == 1 else blocks), truth, payload


def check_truth(spec, outs, truth, C):
    """Every planted frame decodes exactly once, in order, at its planted
    start, with exact bytes."""
    cfg = spec.cfg
    buf = cfg.rx_buf_size * cfg.frame_len
    got = [[] for _ in range(C)]
    for b, out in enumerate(outs):
        pos = out.positions.cpu().numpy().reshape(C, -1)
        valid = out.valid.cpu().numpy().reshape(C, -1)
        mac = out.mac_bytes.cpu().numpy().reshape(C, valid.shape[1], -1)
        for c in range(C):
            for k in np.flatnonzero(valid[c]):
                got[c].append((b * buf - cfg.frame_len + int(pos[c, k])
                               - cfg.t2sin_size, mac[c, k]))
    for c in range(C):
        want = truth[c]
        check([s for s, _ in got[c]] == [s for s, _ in want],
              f"C={C} channel {c}: decoded starts {[s for s, _ in got[c]]} "
              f"!= planted {[s for s, _ in want]}")
        for (s, gb), (_, wb) in zip(got[c], want):
            check(np.array_equal(gb, wb),
                  f"C={C} channel {c}: bytes of the frame at {s} differ")
    return sum(len(w) for w in truth)


def feed_all(rxr, blocks):
    return [rxr.feed(blk) for blk in blocks]


def same_outputs(a, b, tag, atol=0.0):
    """Every StreamOut field of two runs equal: positions, valid, num_found
    exactly, mac_bytes exactly on the valid slots (an invalid slot
    demodulates the window at ring start 0, masked by ``valid``), diag and
    cfo within ``atol`` on the valid slots."""
    worst = 0.0
    for i, (x, y) in enumerate(zip(a, b)):
        for name in ("positions", "valid", "num_found"):
            check(torch.equal(getattr(x, name).cpu(), getattr(y, name).cpu()),
                  f"{tag}: buffer {i} {name} differs")
        v = y.valid.cpu()
        check(torch.equal(x.mac_bytes.cpu()[v], y.mac_bytes.cpu()[v]),
              f"{tag}: buffer {i} mac_bytes differ")
        for name in ("diag", "cfo"):
            d = (getattr(x, name).cpu()[v] - getattr(y, name).cpu()[v]).abs()
            err = float(d.max()) if d.numel() else 0.0
            worst = max(worst, err)
            check(err <= atol, f"{tag}: buffer {i} {name} differs by {err} "
                  f"(> {atol})")
    return worst


def run_streaming(dev, profile=None):
    """Phases 8-12: the streaming receiver at C = 1, 8, 64."""
    from c_ofdm_tpu_torch import ModemConfig, make_frame_spec
    from c_ofdm_tpu_torch.models import streaming
    from c_ofdm_tpu_torch.ops import extract
    cfg = ModemConfig()
    spec = make_frame_spec(cfg, torch.complex64, device=dev,
                           fft_backend="matmul")
    buf = cfg.rx_buf_size * cfg.frame_len
    data = {C: streaming_buffers(spec, C, SEED + 10 + C) for C in CHANNELS}
    torch.cuda.synchronize()
    kernels = {"single": extract.extract_windows_single,
               "multi": extract.extract_windows_multi}

    # ---- 8: the main streaming path, counts from 0
    for fn in (extract.extract_windows, *kernels.values()):
        fn.launches = 0
        fn.class_launches = dict.fromkeys(extract.CLASSES, 0)
    K = cfg.rx_buf_size + 1
    path_shapes = ((K + cfg.t2_gate_slack,
                    cfg.gated_search_lags + cfg.pr_sin_len),
                   (K, cfg.preamble_len + cfg.message_len))
    outs = {}
    for C in CHANNELS:
        rxr = streaming.StreamingReceiver(spec, channels=0 if C == 1 else C)
        per_buf = []
        outs[C] = []
        fn = kernels["single" if C == 1 else "multi"]
        classes_before = dict(fn.class_launches)
        for blk in data[C][0]:
            before = {k: f.launches for k, f in kernels.items()}
            outs[C].append(rxr.feed(blk))
            per_buf.append({k: f.launches - before[k]
                            for k, f in kernels.items()})
        torch.cuda.synchronize()
        want = {"single": 2, "multi": 0} if C == 1 else {"single": 0,
                                                        "multi": 2}
        check(all(p == want for p in per_buf),
              f"C={C}: kernel launches per buffer {per_buf}, want {want}")
        ran = {k: v - classes_before[k]
               for k, v in fn.class_launches.items() if v != classes_before[k]}
        want_classes = {}
        for k, win in path_shapes:
            name = extract.launch_class(C * k, win, 8)
            want_classes[name] = want_classes.get(name, 0) + S
        check(ran == want_classes, f"C={C}: launches by class {ran}, the "
              f"shapes name {want_classes}")
        n_frames = check_truth(spec, outs[C], data[C][1], C)
        say("stream", f"C={C}: launches by class {ran}")
        say("stream", f"C={C}: {S} buffers of {buf} samples, {n_frames} "
            f"planted frames decoded exactly once, in order, at their "
            f"planted starts, bytes exact; "
            f"{'K2' if C == 1 else 'K3'} launches per buffer "
            f"{[p['single' if C == 1 else 'multi'] for p in per_buf]}")
    launches = {k: f.launches for k, f in kernels.items()}
    check(extract.extract_windows.launches == 0,
          "the streaming path launched K1")
    check(launches["single"] == 2 * S and launches["multi"] == 2 * S * (
        len(CHANNELS) - 1), f"streaming launches {launches}")

    # ---- 9: the same buffers through the port's plain CPU run
    cpu_spec = make_frame_spec(cfg, torch.complex64, device="cpu",
                               fft_backend="matmul")
    for C in CPU_CHANNELS:
        rxc = streaming.StreamingReceiver(cpu_spec,
                                          channels=0 if C == 1 else C)
        cpu_outs = feed_all(rxc, [b.cpu() for b in data[C][0]])
        err = same_outputs(outs[C], cpu_outs, f"C={C} card vs CPU",
                           atol=1e-3)
        say("stream-cpu", f"C={C}: positions, valid, num_found and the valid "
            f"slots' mac_bytes equal to the CPU run in all {S} buffers; diag "
            f"and cfo max abs diff {err:.3g} (tolerance 1e-3, float32 on two "
            f"devices)")

    # ---- 10: checkpoint after buffer 2, resume in a new receiver
    C = STATE_C
    blocks = data[C][0]
    first = streaming.StreamingReceiver(spec, channels=C)
    feed_all(first, blocks[:2])
    f = io.BytesIO()
    streaming.save_state(f, first.state)
    f.seek(0)
    resumed = streaming.StreamingReceiver(spec, channels=C)
    resumed.state = streaming.load_state(f, device=dev)
    same_outputs(feed_all(resumed, blocks[2:]), outs[C][2:],
                 f"C={C} resumed from a checkpoint")
    say("state", f"C={C}: save_state after buffer 2 ({f.getbuffer().nbytes} "
        f"bytes), load_state into a new receiver: buffers 3-{S} identical "
        f"to the uninterrupted run")

    # ---- 11: no host synchronisation inside one gated buffer, eager
    # (process_buffer) and as the receiver's graph replay (captured first)
    rxr = streaming.StreamingReceiver(spec, channels=C)
    rxr.feed(blocks[0])
    rxr.state = streaming.init_state(spec, channels=C)
    state = streaming.init_state(spec, channels=C)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, eager = streaming.process_buffer(spec, state, blocks[0])
        out = rxr.feed(blocks[0])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    same_outputs([eager], outs[C][:1], f"C={C} eager under sync debug mode")
    same_outputs([out], outs[C][:1], f"C={C} replay under sync debug mode")
    say("no-sync", f"C={C}: one gated buffer ran under "
        f"set_sync_debug_mode('error') with no host synchronisation, as "
        f"eager process_buffer and as the receiver's graph replay")

    # ---- 12: timing
    kernel_ms, plain_ms, bound, library_ms = stream_timing(spec, data,
                                                           profile)

    # ---- 13: the same C = 8 buffers under pallas (K4 in the demod)
    run_pallas_stream(dev, data[STATE_C])
    return {"launches": launches, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound,
            "library_ms": library_ms, "data": data}


def run_pallas_stream(dev, data):
    """Phase 13: S consecutive C = 8 buffers under fft_backend="pallas":
    every planted frame exact, K4 launched once (the demod of C·41·9
    symbols) and K3 twice per buffer; per-buffer median and device time."""
    from c_ofdm_tpu_torch import ModemConfig, make_frame_spec
    from c_ofdm_tpu_torch.models import streaming
    from c_ofdm_tpu_torch.ops import dft, extract
    C = STATE_C
    cfg = ModemConfig()
    spec = make_frame_spec(cfg, torch.complex64, device=dev,
                           fft_backend="pallas")
    blocks, truth, _ = data
    rxr = streaming.StreamingReceiver(spec, channels=C)
    outs, per_buf = [], []
    for blk in blocks:
        before = (dft.dft.radix_launches, dft.dft.dense_launches,
                  extract.extract_windows_multi.launches)
        outs.append(rxr.feed(blk))
        per_buf.append((dft.dft.radix_launches - before[0],
                        dft.dft.dense_launches - before[1],
                        extract.extract_windows_multi.launches - before[2]))
    torch.cuda.synchronize()
    check(all(p == (1, 0, 2) for p in per_buf),
          f"pallas C={C}: (radix K4, dense K4, K3) launches per buffer "
          f"{per_buf}, want (1, 0, 2)")
    n_frames = check_truth(spec, outs, truth, C)
    step = itertools.count()

    def feed(_):
        rxr.feed(blocks[next(step) % S])

    ms = [cuda_ms(feed, 1) for _ in range(12)]
    med = statistics.median(ms)
    dev_ms, _ = device_ms(feed, 8)
    buf = cfg.rx_buf_size * cfg.frame_len
    say("pallas-stream", f"C={C}: {S} buffers, {n_frames} planted frames "
        f"decoded exactly once, in order, at their planted starts; (radix "
        f"K4, dense K4, K3) launches per buffer {per_buf}; per buffer median "
        f"{med:.4f} ms ({C * buf / (med * 1e-3):.4g} samples/s), device "
        f"{dev_ms:.4f} ms (idle {1 - dev_ms / med:.1%})")


def stream_timing(spec, data, profile=None):
    """Phase 12: per-buffer time at C = 1/8/64, then K2/K3 against their
    plain versions and the library call.  Returns the device ms per buffer
    of the two K2 launches at C = 1 and of the two K3 launches at C = 8:
    kernel, plain, bound, library."""
    from torch.autograd import DeviceType
    from c_ofdm_tpu_torch.models import streaming
    from c_ofdm_tpu_torch.ops import extract
    cfg = spec.cfg
    buf = cfg.rx_buf_size * cfg.frame_len
    n = buf + cfg.frame_len
    for C in CHANNELS:
        blocks = data[C][0]
        rxr = streaming.StreamingReceiver(spec, channels=0 if C == 1 else C)
        step = itertools.count()

        def feed(_, rxr=rxr, blocks=blocks, step=step):
            rxr.feed(blocks[next(step) % S])

        for i in range(3):
            feed(i)
        torch.cuda.synchronize()
        ms = [cuda_ms(feed, 1) for _ in range(24)]
        med = statistics.median(ms)
        dev_ms, events = device_ms(feed, 10)
        launches = sum(e.count for e in events
                       if e.device_type == DeviceType.CUDA) / 10
        say("stream-timing", f"C={C}: per buffer median {med:.4f} ms over "
            f"{len(ms)} buffers (min {min(ms):.4f}, max {max(ms):.4f}), "
            f"{C * buf / (med * 1e-3):.4g} samples/s; device time "
            f"{dev_ms:.4f} ms per buffer in {launches:.0f} kernels (kernel "
            f"sum, torch.profiler over 10 buffers): device idle "
            f"{1 - dev_ms / med:.1%}")
        if profile:
            with open(f"{profile}.stream_c{C}", "w") as f:
                for key in ("self_cuda_time_total", "self_cpu_time_total"):
                    f.write(events.table(sort_by=key, row_limit=60) + "\n")
            say("profile", f"10 buffers at C={C} -> {profile}.stream_c{C}")

    # K2/K3 against their plain versions on a ring of the path's size, at
    # the path's two (K, win) pairs, starts drawn as the path draws them
    K = cfg.rx_buf_size + 1
    pairs = ((K + cfg.t2_gate_slack, cfg.gated_search_lags + cfg.pr_sin_len),
             (K, cfg.preamble_len + cfg.message_len))
    g = torch.Generator(device=spec.device).manual_seed(SEED + 3)
    totals = {}
    for C in CHANNELS:
        name = "single" if C == 1 else "multi"
        rings = torch.randn(C, n, dtype=torch.complex64, device=spec.device,
                            generator=g)
        for k, win in pairs:
            st = torch.randint(0, n - win + 1, (C, k), dtype=torch.int32,
                               device=spec.device, generator=g)
            if C == 1:
                x, s = rings[0], st[0]
                fns = {"kernel": lambda i, x=x, s=s, w=win:
                       extract.extract_windows_single(x, s, w),
                       "plain": lambda i, x=x, s=s, w=win:
                       extract.extract_windows_single_ref(x, s, w),
                       "library": library_gather(x, s, win)}
            else:
                fns = {"kernel": lambda i, x=rings, s=st, w=win:
                       extract.extract_windows_multi(x, s, w),
                       "plain": lambda i, x=rings, s=st, w=win:
                       extract.extract_windows_multi_ref(x, s, w),
                       "library": library_gather(rings, st, win)}
            for fn in fns.values():
                cuda_ms(fn, 16)
            wall = {key: [] for key in fns}
            devt = {key: [] for key in fns}
            for order in (tuple(fns), tuple(reversed(fns))) * 2:
                for key in order:
                    wall[key].append(cuda_ms(fns[key], 100))
                    devt[key].append(device_ms(fns[key], 32)[0])
            moved = 2 * C * k * win * 8
            totals[(C, "bound")] = totals.get((C, "bound"), 0.0) + bytes_ms(
                moved + C * k * 4)
            for key in fns:
                d = statistics.median(devt[key])
                totals[(C, key)] = totals.get((C, key), 0.0) + d
                say("stream-timing", f"{'K2' if C == 1 else 'K3'} "
                    f"[{C},{n}] K={k} win={win} c64, {key}: device "
                    f"{d * 1e3:.3f} us ({moved / (d * 1e-3) / 1e9:.1f} GB/s "
                    f"effective, {moved / (d * 1e-3) / 3.35e12:.1%} of "
                    f"3.35 TB/s); {statistics.median(wall[key]) * 1e3:.2f} "
                    f"us per call with host dispatch")
        say("stream-timing", f"{'K2' if C == 1 else 'K3'} C={C}, both "
            f"launches of one buffer: kernel {totals[(C, 'kernel')]:.5f} ms, "
            f"plain {totals[(C, 'plain')]:.5f} ms, library (unfold + index) "
            f"{totals[(C, 'library')]:.5f} ms (device), bound "
            f"{totals[(C, 'bound')]:.5f} ms (bytes)")
    return tuple({"single": totals[(1, key)], "multi": totals[(8, key)]}
                 for key in ("kernel", "plain", "bound", "library"))


def impaired_captures(frames, rng, extra=EXTRA, amp=40.0, cfo=1e-4,
                      zero_rows=ZERO_ROWS):
    """frames [B, frame_len] complex -> captures [B + zero_rows,
    frame_len + extra] complex64 (numpy) and the planted offsets: each
    frame at a random offset in [0, extra], amplitude ``amp``, CFO ``cfo``
    cycles/sample, AWGN at 30 dB SNR (as __graft_entry__.py builds its
    impaired streams), then ``zero_rows`` all-zero rows."""
    nb, flen = frames.shape
    n = flen + extra
    offs = rng.integers(0, extra + 1, nb)
    caps = np.zeros((nb + zero_rows, n), np.complex128)
    for b in range(nb):
        caps[b, offs[b]:offs[b] + flen] = frames[b] * amp
    caps[:nb] *= np.exp(2j * np.pi * cfo * np.arange(n))
    std = np.sqrt(float((np.abs(frames) ** 2).mean()) * amp ** 2
                  * 10 ** (-30.0 / 10) / 2)
    caps[:nb] += std * (rng.standard_normal((nb, n))
                        + 1j * rng.standard_normal((nb, n)))
    return caps.astype(np.complex64), offs


def time_step(phase, step, payload, samples, reps=30):
    """Step median over ``reps`` runs (CUDA events), samples/s, and the
    device time and idle share over 10 steps (torch.profiler).  Returns
    (median ms, device ms, profiler events)."""
    for _ in range(5):
        step(payload)
    torch.cuda.synchronize()
    step_ms = [cuda_ms(lambda i: step(payload), 1) for _ in range(reps)]
    med = statistics.median(step_ms)
    dev_ms, events = device_ms(lambda i: step(payload), 10)
    say(phase, f"step (TX+RX, B={payload.shape[0]}): median {med:.4f} ms "
        f"over {len(step_ms)} runs (min {min(step_ms):.4f}, max "
        f"{max(step_ms):.4f}), {samples / (med * 1e-3):.4g} samples/s; "
        f"device time {dev_ms:.4f} ms (kernel sum, torch.profiler over 10 "
        f"steps): device idle {1 - dev_ms / med:.1%} of the step")
    return med, dev_ms, events


def write_profile(path, events, what):
    """The profiler table of ``events`` (by device time) to ``path``."""
    with open(path, "w") as f:
        f.write(events.table(sort_by="self_cuda_time_total", row_limit=80))
    say("profile", f"{what} -> {path}")


def check_impaired(phase, step, cpu_step, caps_np, offs, payload_np,
                   launches, cpu_rows=None):
    """Receive impaired captures [B + zero rows, n] on the card: every
    frame found at its planted offset with exact bytes, no frame in a zero
    row, the kernel launches ``launches`` (a dict of wrappers -> count);
    sync fields and found rows' bytes equal to the port's CPU run on the
    first ``cpu_rows`` rows (all by default)."""
    nb = payload_np.shape[0]
    caps = torch.from_numpy(caps_np).to(step.spec.device)
    before = {f: f.launches for f in launches}
    res, s = step.receive(caps)
    torch.cuda.synchronize()
    for f, want in launches.items():
        check(f.launches - before[f] == want,
              f"{phase}: {f.__name__} launched {f.launches - before[f]} "
              f"times, not {want}")
    found = s.found.cpu().numpy()
    fs = s.frame_start.cpu().numpy()
    got = res.mac_bytes.cpu().numpy()
    check(found[:nb].all(), f"{phase}: {int((~found[:nb]).sum())} frames lost")
    check(not found[nb:].any(), f"{phase}: a frame found in an all-zero row")
    check(np.array_equal(fs[:nb], offs),
          f"{phase}: frame_start != planted offset on "
          f"{int((fs[:nb] != offs).sum())} rows")
    check(np.array_equal(got[:nb], payload_np), f"{phase}: payload mismatch")
    rows = slice(None, cpu_rows)
    res_c, s_c = cpu_step.receive(torch.from_numpy(caps_np[rows]))
    for name in ("frame_start", "t2_begin", "pr_begin", "found"):
        check(np.array_equal(getattr(s, name).cpu().numpy()[rows],
                             getattr(s_c, name).numpy()),
              f"{phase}: {name} differs from the CPU run")
    fc = found[rows]
    check(np.array_equal(got[rows][fc], res_c.mac_bytes.numpy()[fc]),
          f"{phase}: mac_bytes differ from the CPU run")
    diff = (res.constellation.cpu().numpy()[rows][fc]
            - res_c.constellation.numpy()[fc])
    return int(fc.sum()), float(np.abs(diff).max()) if diff.size else 0.0


def run_dft_checks(dev):
    """Phase 14: K4 against dft_ref and the float64 DFT of the same
    complex64 input, and on the radix route against dft_radix_ref (the
    kernel's passes in plain PyTorch, within RADIX_REF_TOL·max|Y|: the two
    differ only in the rounding of each butterfly); each case on the route
    ``dft._route`` names.  Returns the worst |K4 - dft_ref|."""
    from c_ofdm_tpu_torch import ModemConfig
    from c_ofdm_tpu_torch.ops import dft
    cfg = ModemConfig()
    nsym = cfg.num_pr_symb + cfg.num_symb
    g = torch.Generator(device=dev).manual_seed(SEED + 4)

    def randc(*shape):
        return torch.randn(*shape, dtype=torch.complex64, device=dev,
                           generator=g)

    rx = randc(B, nsym * cfg.ofdm_len).reshape(B, nsym, cfg.ofdm_len)
    cases = [
        ("RX view", rx[..., cfg.cp_size:], -1, 1.0),
        ("TX", randc(B, cfg.num_symb, cfg.fft_size), +1, 1.0),
        ("n=256 scaled", randc(512, 256), +1, 1.0 / 16),
        ("ragged", randc(1000, 512), -1, 1.0),
        ("leading dims", randc(2, 3, 256), -1, 1.0),
        ("n=500", randc(77, 500), +1, 1.0),
        ("n=64", randc(4099, 64), -1, 1.0),
        ("n=1024 scaled", randc(333, 1024), +1, 1.0 / 32),
        ("n=8192", randc(37, 8192), -1, 1.0),
    ]
    worst = 0.0
    for label, x, sign, scale in cases:
        route = dft._route(x.shape[-1])
        before = (dft.dft.radix_launches, dft.dft.dense_launches)
        got = dft.dft(x, sign, scale)
        counts = (dft.dft.radix_launches - before[0],
                  dft.dft.dense_launches - before[1])
        plain = dft.dft_ref(x, sign, scale)
        x64 = x.to(torch.complex128)
        want = (torch.fft.fft(x64) if sign < 0
                else torch.fft.ifft(x64) * x.shape[-1]) * scale
        torch.cuda.synchronize()
        check(counts == ((1, 0) if route == "radix" else (0, 1)),
              f"K4 {label}: (radix, dense) launches {counts} on the {route} "
              f"route")
        ymax = float(want.abs().max())
        err = float((got.to(torch.complex128) - want).abs().max())
        err_p = float((plain.to(torch.complex128) - want).abs().max())
        diff = float((got - plain).abs().max())
        worst = max(worst, diff)
        check(got.shape == x.shape and got.dtype == torch.complex64,
              f"K4 {label}: output {tuple(got.shape)} {got.dtype}")
        check(err <= 1e-5 * ymax and err <= 4 * err_p,
              f"K4 {label}: max abs err {err:.3e} vs the float64 DFT, plain "
              f"{err_p:.3e}, max|Y| {ymax:.3e} (need <= 1e-5 max|Y| and "
              f"<= 4x plain)")
        vs_radix = ""
        if route == "radix":
            d = float((got - dft.dft_radix_ref(x, sign, scale)).abs().max())
            check(d <= RADIX_REF_TOL * ymax,
                  f"K4 {label}: |K4 - dft_radix_ref| {d:.3e} > "
                  f"{RADIX_REF_TOL:g} max|Y| ({ymax:.3e})")
            vs_radix = f", |K4 - dft_radix_ref| {d / ymax:.2e} of max|Y|"
        say("dft", f"K4 {label} {tuple(x.shape)} sign {sign:+d} scale "
            f"{scale:.4g}, {route} route: max abs err vs float64 {err:.3e} "
            f"({err / ymax:.2e} of max|Y|), plain {err_p:.3e}; "
            f"|K4 - plain| {diff:.3e}{vs_radix}")
    return worst


def run_pallas_step(dev, payload_np, caps_np, offs, profile=None):
    """Phase 15: the flagship step under pallas.  Returns (K4 launches in
    the clean step, step median ms, device ms)."""
    from c_ofdm_tpu_torch import ModemConfig, make_frame_spec
    from c_ofdm_tpu_torch.models.modem import FlagshipStep
    from c_ofdm_tpu_torch.ops import dft, extract
    cfg = ModemConfig()
    step = FlagshipStep(make_frame_spec(cfg, torch.complex64, device=dev,
                                        fft_backend="pallas"))
    payload = torch.from_numpy(payload_np).to(dev)
    # ---- the main path of K4, counts from 0
    dft.dft.launches = dft.dft.radix_launches = dft.dft.dense_launches = 0
    extract.extract_windows.launches = 0
    res, s = step(payload)
    torch.cuda.synchronize()
    k4, k1 = dft.dft.launches, extract.extract_windows.launches
    routes = (dft.dft.radix_launches, dft.dft.dense_launches)
    check((k4, k1) == (2, 1),
          f"pallas step: K4 launched {k4} times and K1 {k1}, want 2 and 1")
    check(routes == (2, 0), f"pallas step: (radix, dense) K4 launches "
          f"{routes}, want (2, 0)")
    check(torch.equal(res.mac_bytes, payload), "pallas step: payload mismatch")
    check(bool(s.found.all()) and not bool(s.frame_start.any()),
          "pallas step: a clean frame not found at 0")
    say("pallas", f"clean B={B}: payloads exact, K4 launches {k4} (TX "
        f"[{B * cfg.num_symb},{cfg.fft_size}] and RX "
        f"[{B * (cfg.num_pr_symb + cfg.num_symb)},{cfg.fft_size}]; radix "
        f"{routes[0]}, dense {routes[1]}), K1 {k1}")
    cpu_step = FlagshipStep(make_frame_spec(cfg, torch.complex64,
                                            device="cpu",
                                            fft_backend="pallas"))
    radix_before = dft.dft.radix_launches
    n_found, err = check_impaired(
        "pallas", step, cpu_step, caps_np, offs, payload_np,
        {dft.dft: 1, extract.extract_windows: 1})
    check(dft.dft.radix_launches == radix_before + 1,
          "pallas impaired receive: K4 not launched on the radix route")
    say("pallas", f"impaired B={B}+{ZERO_ROWS}: all frames at their planted "
        f"offsets, payloads exact, zero rows not found, K4 once (radix) in the "
        f"receive; sync and bytes of the {n_found} found rows equal to the "
        f"CPU run (constellation max abs diff {err:.3g})")
    med, dev_ms, events = time_step("pallas", step, payload,
                                    B * cfg.frame_len)
    if profile:
        write_profile(f"{profile}.pallas", events, "10 pallas steps")
    return k4, med, dev_ms


def run_backends(dev, payload_np):
    """Phase 16: the stock step under the other full-spectrum and bf16
    backends: clean payloads exact, K4 never launched."""
    from c_ofdm_tpu_torch import ModemConfig, make_frame_spec
    from c_ofdm_tpu_torch.models.modem import FlagshipStep
    from c_ofdm_tpu_torch.ops import dft
    cfg = ModemConfig()
    payload = torch.from_numpy(payload_np).to(dev)
    for backend in OTHER_BACKENDS:
        step = FlagshipStep(make_frame_spec(cfg, torch.complex64, device=dev,
                                            fft_backend=backend))
        before = dft.dft.launches
        res, s = step(payload)
        torch.cuda.synchronize()
        check(dft.dft.launches == before, f"{backend}: K4 launched")
        check(torch.equal(res.mac_bytes, payload) and bool(s.found.all()),
              f"{backend}: clean payloads not decoded exactly")
        for _ in range(3):
            step(payload)
        ms = statistics.median(cuda_ms(lambda i: step(payload), 1)
                               for _ in range(10))
        say("backends", f"{backend}: B={B} payloads exact, K4 never "
            f"launched; step median {ms:.4f} ms over 10 runs")


def run_wideband(dev, profile=None):
    """Phase 17: the 8k-QAM64 step under ct at B = 128.  Returns (step
    median ms, device ms)."""
    from c_ofdm_tpu_torch import ModemConfig, make_frame_spec
    from c_ofdm_tpu_torch.models import tx
    from c_ofdm_tpu_torch.models.modem import FlagshipStep
    from c_ofdm_tpu_torch.ops import dft, extract
    cfg = ModemConfig(**WIDEBAND)
    spec = make_frame_spec(cfg, torch.complex64, device=dev,
                           fft_backend="ct")
    step = FlagshipStep(spec)
    rng = np.random.default_rng(SEED + 5)
    payload_np = rng.integers(0, 256, (B_WIDE, cfg.frame_bytes),
                              dtype=np.uint8)
    payload = torch.from_numpy(payload_np).to(dev)
    before = dft.dft.launches
    res, s = step(payload)
    torch.cuda.synchronize()
    check(torch.equal(res.mac_bytes, payload) and bool(s.found.all())
          and not bool(s.frame_start.any()),
          "wideband: clean payloads not decoded exactly")
    say("wideband", f"clean B={B_WIDE} frames of {cfg.frame_len} samples "
        f"(fft {cfg.fft_size}, QAM{1 << cfg.mod_type}, ct): payloads exact")
    frames = tx.transmit(step.bound_spec(), payload).cpu().numpy()
    caps_np, offs = impaired_captures(frames.astype(np.complex128), rng,
                                      extra=EXTRA_WIDE, amp=10.0, cfo=1e-5,
                                      zero_rows=0)
    cpu_step = FlagshipStep(make_frame_spec(cfg, torch.complex64,
                                            device="cpu", fft_backend="ct"))
    n_cpu, err = check_impaired("wideband", step, cpu_step, caps_np, offs,
                                payload_np, {extract.extract_windows: 1},
                                cpu_rows=4)
    check(dft.dft.launches == before, "wideband: K4 launched under ct")
    say("wideband", f"impaired B={B_WIDE} captures of {caps_np.shape[1]} "
        f"samples, offsets {int(offs.min())}..{int(offs.max())}, CFO 1e-5, "
        f"30 dB: all frames at their planted offsets, payloads exact; "
        f"{n_cpu} rows equal to the CPU run (constellation max abs diff "
        f"{err:.3g})")
    med, dev_ms, events = time_step("wideband", step, payload,
                                    B_WIDE * cfg.frame_len, reps=20)
    if profile:
        write_profile(f"{profile}.wideband", events, "10 wideband steps")
    return med, dev_ms


def dft_timing(dev):
    """Phase 18: K4 at the pallas step's two shapes (device time,
    torch.profiler) against its bound, dft_radix_ref (the radix kernel's
    passes in plain PyTorch), its plain version dft_ref, the library call
    (torch.fft.fft for sign -1; torch.fft.ifft with norm="forward", the
    unnormalized backward transform, for sign +1) and complex torch.matmul
    with the cached W, under two L2 conditions: warm (one input, reused by
    every call; 17-19 MB stays in the 50 MB L2) and cold (COLD_SETS inputs
    in turn, over 100 MB per shape, so each call finds its input outside
    the L2, as after a fresh capture); and the same at [2952, 512], the one
    launch of a C = 8 pallas streaming buffer, outside the per-step sums.
    The bound is that of the function,
    a DFT: x read and y written once at the HBM rate, against the radix-2
    FFT's 5·M·n·log2(n) operations at the float32 rate; the dense product's
    floor (8·M·n² at the float32 rate) is printed beside it.  Then the
    dense route once at [2304, 500], warm.  Returns {"warm": sums, "cold":
    sums} of per-step ms {kernel, radix_ref, plain, library, matmul}, and
    "bound", "bound_by", "dense" (per step)."""
    from c_ofdm_tpu_torch import ModemConfig
    from c_ofdm_tpu_torch.ops import dft
    cfg = ModemConfig()
    nsym = cfg.num_pr_symb + cfg.num_symb
    g = torch.Generator(device=dev).manual_seed(SEED + 6)

    def make(label):
        if label == "TX":
            return torch.randn(B, cfg.num_symb, cfg.fft_size,
                               dtype=torch.complex64, device=dev, generator=g)
        rows = B if label == "RX" else STATE_C * (cfg.rx_buf_size + 1)
        sig = torch.randn(rows, nsym * cfg.ofdm_len, dtype=torch.complex64,
                          device=dev, generator=g)
        return sig.reshape(rows, nsym, cfg.ofdm_len)[..., cfg.cp_size:]

    keys = ("kernel", "radix_ref", "plain", "library", "matmul")
    out = {cond: dict.fromkeys(keys, 0.0) for cond in ("warm", "cold")}
    out["bound"] = out["dense"] = 0.0
    limits = {"bytes": 0.0, "operations": 0.0}
    for label, sign in (("TX", +1), ("RX", -1), ("stream", -1)):
        # "stream": the pallas streaming buffer's one launch at C = 8, the
        # CP-stripped symbols of 8 x 41 frame windows; not part of a step
        in_step = label != "stream"
        xs = [make(label) for _ in range(COLD_SETS)]
        n = xs[0].shape[-1]
        m = xs[0].numel() // n
        w = dft.dft_planes(n, sign, 1.0, dev)
        wc = torch.complex(w[0], w[1])
        x2s = [x.reshape(m, n) for x in xs]
        nbytes = 2 * m * n * 8
        check(COLD_SETS * nbytes / 2 > 2 * L2_BYTES,
              f"{label}: {COLD_SETS} input sets do not exceed the L2 twice")
        fft_flops = 5 * m * n * math.log2(n)
        dense_flops = 8 * m * n * n
        by = {"bytes": bytes_ms(nbytes),
              "operations": fft_flops / FP32_FLOP_S * 1e3}
        bound = max(by.values())
        dense = dense_flops / FP32_FLOP_S * 1e3
        if in_step:
            out["bound"] += bound
            out["dense"] += dense
            for k in by:
                limits[k] += by[k]
        for cond, sets in (("warm", 1), ("cold", COLD_SETS)):
            lib = ((lambda i: torch.fft.fft(xs[i % sets])) if sign < 0
                   else (lambda i: torch.fft.ifft(xs[i % sets],
                                                  norm="forward")))
            fns = {"kernel": lambda i: dft.dft(xs[i % sets], sign),
                   "radix_ref": lambda i: dft.dft_radix_ref(xs[i % sets],
                                                            sign),
                   "plain": lambda i: dft.dft_ref(xs[i % sets], sign),
                   "library": lib,
                   "matmul": lambda i: x2s[i % sets] @ wc}
            for fn in fns.values():
                cuda_ms(fn, 2 * sets)
            devt = {k: [] for k in fns}
            for order in (tuple(fns), tuple(reversed(fns))):
                for k in order:
                    devt[k].append(device_ms(fns[k], 24)[0])
            med = {k: statistics.median(v) for k, v in devt.items()}
            for k in keys:
                out[cond][k] += med[k] if in_step else 0.0
            say("dft-timing", f"K4 {label} [{m},{n}] sign {sign:+d}, {cond} "
                f"L2: kernel {med['kernel'] * 1e3:.3f} us, "
                f"{bound / med['kernel']:.1%} of the bound {bound * 1e3:.3f} "
                f"us ({nbytes / 1e6:.1f} MB of x and y at 3.35 TB/s; "
                f"{fft_flops / 1e6:.1f} MFLOP of an FFT at 67 TFLOP/s fp32), "
                f"{nbytes / (med['kernel'] * 1e-3) / 1e9:.0f} GB/s; "
                f"dft_radix_ref {med['radix_ref'] * 1e3:.3f} us; plain "
                f"(dft_ref) {med['plain'] * 1e3:.3f} us; library (torch.fft) "
                f"{med['library'] * 1e3:.3f} us (K4 / library "
                f"{med['kernel'] / med['library']:.2f}); complex torch.matmul "
                f"with W {med['matmul'] * 1e3:.3f} us (device, median of 2 "
                f"profiled runs of 24; dense product's floor "
                f"{dense * 1e3:.3f} us)")
    out["bound_by"] = max(limits, key=limits.get)
    for cond in ("warm", "cold"):
        t = out[cond]
        say("dft-timing", f"K4 per pallas step (TX + RX), {cond} L2: kernel "
            f"{t['kernel']:.5f} ms ({out['bound'] / t['kernel']:.1%} of the "
            f"bound {out['bound']:.5f} ms, {out['bound_by']}), library "
            f"{t['library']:.5f} ms (K4 / library "
            f"{t['kernel'] / t['library']:.3f}), dft_radix_ref "
            f"{t['radix_ref']:.5f} ms, plain {t['plain']:.5f} ms, complex "
            f"matmul {t['matmul']:.5f} ms")

    # the dense route once, at the RX row count and n = 500
    x = torch.randn(B * nsym, 500, dtype=torch.complex64, device=dev,
                    generator=g)
    check(dft._route(500) == "dense", "n = 500 not on the dense route")
    fns = {"kernel": lambda i: dft.dft(x, -1),
           "library": lambda i: torch.fft.fft(x)}
    for fn in fns.values():
        cuda_ms(fn, 4)
    med = {k: device_ms(fn, 24)[0] for k, fn in fns.items()}
    nb = 2 * x.numel() * 8
    say("dft-timing", f"K4 dense route [{x.shape[0]},500] sign -1, warm L2: "
        f"kernel {med['kernel'] * 1e3:.3f} us against the bound "
        f"{bytes_ms(nb) * 1e3:.3f} us (bytes) and the dense product's floor "
        f"{8 * x.shape[0] * 500 ** 2 / FP32_FLOP_S * 1e6:.3f} us; library "
        f"(torch.fft) {med['library'] * 1e3:.3f} us")
    return out


def gather_timing(dev):
    """Phase 19: the window gather (K1, K2, K3) body against body, all in
    this one call on this one card (device time, torch.profiler).

    First the card's floor per launch: a kernel that does nothing, on grids
    (1), (49, 4) and (41, 23) of 256 threads (one block, and one thread per
    element of K2's two launches) and on the two grids the C = 1 path
    really launches (``launch_plan``).  Then each case in turns (scalar,
    wide, library, and back): the scalar body and the wide body, each forced
    by ``body=``, and the library call, at the shapes the paths give the
    kernels, starts drawn as the paths draw them (candidate regions at
    multiples of the 128-sample hop, frame windows at any parity).  "warm"
    reuses one input (a streaming ring that torch.cat has just written is
    in the 50 MB L2), "cold" takes enough inputs in turn to exceed the L2.
    Each line gives the byte bound (windows read and written once, starts
    read once, at 3.35 TB/s), the class ``launch_class`` names for the
    shape, which is what the path runs, and the fastest body of this call.
    Returns nothing: the kernels line takes its times from phases 6 and
    12."""
    from c_ofdm_tpu_torch import ModemConfig
    from c_ofdm_tpu_torch.ops import extract
    cfg = ModemConfig()
    wide = ModemConfig(**WIDEBAND)
    n = (cfg.rx_buf_size + 1) * cfg.frame_len
    K = cfg.rx_buf_size + 1
    hop = cfg.t2sin_size // 2
    regions = (K + cfg.t2_gate_slack, cfg.gated_search_lags + cfg.pr_sin_len)
    frames = (K, cfg.preamble_len + cfg.message_len)
    g = torch.Generator(device=dev).manual_seed(SEED + 7)

    path_grids = []
    for k, win in (regions, frames):
        plan = extract.launch_plan(k, win, 8)
        path_grids.append(((k, plan.tiles), plan.threads))
    grids = [((1, 1), 256), ((regions[0], -(-regions[1] // 256)), 256),
             ((frames[0], -(-frames[1] // 256)), 256)]
    grids += [pg for pg in path_grids if pg not in grids]
    floor = {}
    for grid, threads in grids:
        def fn(i, grid=grid, threads=threads):
            extract.empty_launch(grid, threads, dev)
        cuda_ms(fn, 32)
        floor[(grid, threads)] = statistics.median(
            device_ms(fn, 64)[0] for _ in range(6))
        say("gather-timing", f"empty kernel, grid {grid} x {threads} "
            f"threads: device {floor[(grid, threads)] * 1e3:.3f} us per "
            f"launch (median of 6 profiled runs of 64)")
    k2_floor = sum(floor[pg] for pg in path_grids)

    def draw(shape, k, win, n_in, parity=None):
        """Starts in [0, n_in - win]: at multiples of the hop for the
        candidate regions, else at any (or one) parity."""
        if (k, win) == regions:
            return hop * torch.randint(0, (n_in - win) // hop + 1, shape,
                                       device=dev, generator=g)
        if parity is not None:
            return parity + 2 * torch.randint(0, (n_in - win) // 2, shape,
                                              device=dev, generator=g)
        return torch.randint(0, n_in - win + 1, shape, device=dev,
                             generator=g)

    def run(label, kind, xs, sts, win, cond, rounds, extra=""):
        """One case: xs/sts input sets taken in turn; returns {body: ms}."""
        fn = {"K1": extract.extract_windows,
              "K2": extract.extract_windows_single,
              "K3": extract.extract_windows_multi}[kind]
        sets = len(xs)
        fns = {b: (lambda i, b=b: fn(xs[i % sets], sts[i % sets], win,
                                     body=b))
               for b in extract.CLASSES}
        libs = [library_gather(x, st, win) for x, st in zip(xs, sts)]
        fns["library"] = lambda i: libs[i % sets](i)
        reps = max(24, sets)
        for f in fns.values():
            cuda_ms(f, sets + 2)
        devt = {b: [] for b in fns}
        for order in (tuple(fns), tuple(reversed(fns))) * rounds:
            for b in order:
                devt[b].append(device_ms(fns[b], reps)[0])
        med = {b: statistics.median(v) for b, v in devt.items()}
        windows = sts[0].numel()
        moved = 2 * windows * win * 8 + windows * 8
        bound = bytes_ms(moved)
        runs = extract.launch_class(windows, win, 8)
        best = min(extract.CLASSES, key=med.get)
        say("gather-timing", f"{label} {tuple(xs[0].shape)} K={windows} "
            f"win={win} c64 int64 starts{extra}, {cond} L2 ({sets} input "
            f"set{'s' if sets > 1 else ''}): bound {bound * 1e3:.3f} us "
            f"({moved / 1e6:.2f} MB at 3.35 TB/s); "
            + "; ".join(f"{b} {med[b] * 1e3:.3f} us" for b in med)
            + f"; the path runs {runs} ({bound / med[runs]:.1%} of the "
            f"bound, {med[runs] / med['scalar']:.3f} of scalar, "
            f"{med[runs] / med['library']:.3f} of library); fastest body "
            f"{best} (device, median of {2 * rounds} profiled runs of "
            f"{reps})")
        return med

    def randc(*shape):
        return torch.randn(*shape, dtype=torch.complex64, device=dev,
                           generator=g)

    # K2: one ring of the path's size; cold: 40 rings, 79 MB
    k2 = {}
    for cond, sets in (("warm", 1), ("cold", 40)):
        rings = [randc(n) for _ in range(sets)]
        for name, (k, win) in (("regions", regions), ("frames", frames)):
            sts = [draw((k,), k, win, n) for _ in range(sets)]
            k2[(cond, name)] = run(f"K2 {name}", "K2", rings, sts, win, cond,
                                   rounds=5)
        del rings
    for cond in ("warm", "cold"):
        path = sum(k2[(cond, name)][extract.launch_class(k, win, 8)]
                   for name, (k, win) in (("regions", regions),
                                          ("frames", frames)))
        scalar = sum(k2[(cond, name)]["scalar"]
                     for name in ("regions", "frames"))
        lib = sum(k2[(cond, name)]["library"]
                  for name in ("regions", "frames"))
        moved = sum(2 * k * win * 8 + k * 8 for k, win in (regions, frames))
        say("gather-timing", f"K2 per C = 1 buffer (regions + frames), "
            f"{cond} L2: path {path * 1e3:.3f} us, scalar "
            f"{scalar * 1e3:.3f} us, library {lib * 1e3:.3f} us; byte bound "
            f"{bytes_ms(moved) * 1e3:.3f} us; floor of 2 dependent launches "
            f"{k2_floor * 1e3:.3f} us (the empty kernel on the path's grids "
            f"{path_grids}); floor + bytes "
            f"{(k2_floor + bytes_ms(moved)) * 1e3:.3f} us")

    # K2 frame windows at one parity: aligned 16-byte loads against two
    # 8-byte loads per pair
    ring = [randc(n)]
    for parity in (0, 1):
        st = [draw((frames[0],), *frames, n, parity=parity)]
        run("K2 frames", "K2", ring, st, frames[1], "warm", rounds=3,
            extra=f", all starts {'odd' if parity else 'even'}")
    del ring

    # K3 at C = 8 (ring set 15.8 MB: warm, and 6 sets cold) and C = 64
    # (126 MB: one set is already outside the L2)
    for C, conds in ((8, (("warm", 1), ("cold", 6))), (64, (("cold", 1),))):
        for cond, sets in conds:
            rings = [randc(C, n) for _ in range(sets)]
            for name, (k, win) in (("regions", regions), ("frames", frames)):
                sts = [draw((C, k), k, win, n) for _ in range(sets)]
                run(f"K3 {name}", "K3", rings, sts, win, cond, rounds=3)
            del rings

    # K1 at the flagship shape (8 sets, 98 MB, and one) and at the wideband
    # captures (4 sets, 131 MB)
    wwin = wide.preamble_len + wide.message_len
    for shape, win, conds in (
            ((B, cfg.frame_len), frames[1], (("cold", 8), ("warm", 1))),
            ((B_WIDE, wide.frame_len + EXTRA_WIDE), wwin, (("cold", 4),))):
        for cond, sets in conds:
            xs = [randc(*shape) for _ in range(sets)]
            sts = [draw(shape[:1], 0, win, shape[1]) for _ in range(sets)]
            run("K1", "K1", xs, sts, win, cond, rounds=3)
            del xs


def crc16_scan(data):
    """The byte-serial CRC16-CCITT table walk of the JAX package's
    ``lax.scan`` (c_ofdm_tpu/mac/mac.py:44-57), one step per byte, eagerly
    on the data's device: the form ``Mac``'s crc16 does not take.  Phase 20
    times it beside the matrix form; the port never calls it."""
    from c_ofdm_tpu_torch.mac import mac as macm
    table = torch.from_numpy(macm._CRC_TABLE.astype(np.int64)).to(data.device)
    x = data.to(torch.int64)
    crc = torch.full(data.shape[:-1], 0xFFFF, dtype=torch.int64,
                     device=data.device)
    for k in range(data.shape[-1]):
        crc = ((crc << 8) & 0xFFFF) ^ table[((crc >> 8) ^ x[..., k]) & 0xFF]
    return crc


def profile_call(fn, reps):
    """(device ms per call, CUDA kernels per call) of fn over reps calls,
    torch.profiler; and the wall ms per call by CUDA events."""
    from torch.autograd import DeviceType
    fn(0)
    torch.cuda.synchronize()
    wall = statistics.median(cuda_ms(fn, reps) for _ in range(3))
    ms, events = device_ms(fn, reps)
    kernels = sum(e.count for e in events
                  if e.device_type == DeviceType.CUDA) / reps
    return ms, kernels, wall


def noisy_reads(mac, wire, rng):
    """Inputs of the three read paths made from wire bytes [B, frame_bytes]
    (numpy): the bytes with 2% of the bits flipped (ties of the majority
    vote included), one re+im metric per logical bit and one LLR per wire
    bit, both with noise, signs from the wire; row 0 of each clean."""
    B = wire.shape[0]
    bits = np.unpackbits(wire, axis=-1)
    flips = rng.random(bits.shape) < 0.02
    flips[0] = False
    hard = np.packbits(bits ^ flips, axis=-1)
    lbits = bits[:, ::mac.spread].astype(np.float32)
    diag = (2 * lbits - 1) * (1 + 0.5 * rng.standard_normal(lbits.shape))
    diag[0] = 2 * lbits[0] - 1
    sgn = 1 - 2 * bits.astype(np.float32)
    llr = sgn + 0.8 * rng.standard_normal(bits.shape).astype(np.float32)
    llr[0] = sgn[0]
    return {"read_bytes": hard, "read_soft": diag.astype(np.float32),
            "read_llr": llr.reshape(B, -1, mac.spread)}


def run_mac(dev):
    """Phase 20: the MAC codec on the card.  Returns nothing."""
    from c_ofdm_tpu_torch import ModemConfig
    from c_ofdm_tpu_torch.mac import mac as macm
    rng = np.random.default_rng(SEED + 20)
    for mod in (1, 2, 4, 6, 8):
        cfg = ModemConfig(mod_type=mod)
        for crc in (True, False):
            mac = macm.Mac(frame_bytes=cfg.frame_bytes, spread=mod, crc=crc)
            payload = torch.from_numpy(rng.integers(
                0, 256, (B, mac.payload), dtype=np.uint8))
            seq = torch.from_numpy(rng.integers(0, 2**32, B, dtype=np.int64))
            wire_c = mac.write(payload, seq)
            wire_d = mac.write(payload.to(dev), seq.to(dev))
            check(torch.equal(wire_d.cpu(), wire_c),
                  f"mac: write differs from the CPU run (mod {mod}, crc "
                  f"{crc})")
            clean = mac.read_bytes(wire_d)
            check(bool(clean.valid.all()) and torch.equal(
                clean.payload.cpu(), payload) and torch.equal(
                clean.seq.cpu(), seq), f"mac: mod {mod} crc {crc}: the "
                f"written frames do not read back")
            inputs = noisy_reads(mac, wire_c.numpy(), rng)
            n_valid = {}
            for name, x in inputs.items():
                read = getattr(mac, name)
                cpu = read(torch.from_numpy(x))
                card = read(torch.from_numpy(x).to(dev))
                for field, a, b in zip(macm.MacFrame._fields, cpu, card):
                    check(b.device.type == "cuda" and torch.equal(a, b.cpu()),
                          f"mac: {name} {field} differs from the CPU run "
                          f"(mod {mod}, crc {crc})")
                check(bool(card.valid[0]), f"mac: {name} rejects a clean "
                      f"row (mod {mod}, crc {crc})")
                n_valid[name] = int(card.valid.sum())
            say("mac", f"mod {mod} (spread {mod}, frame_bytes "
                f"{cfg.frame_bytes}), crc {crc}: B={B} write equal to the "
                f"CPU run and read back exactly; read_bytes / read_soft / "
                f"read_llr of noisy inputs equal to the CPU run in every "
                f"field (valid rows {n_valid})")

    # crc16 on random lengths against the table walk in numpy
    lengths = sorted({1, 254, 300, *rng.integers(1, 301, 6).tolist()})
    for n in lengths:
        data = rng.integers(0, 256, (64, n), dtype=np.uint8)
        want = np.full(64, 0xFFFF, dtype=np.int64)
        table = macm._CRC_TABLE.astype(np.int64)
        for k in range(n):
            want = ((want << 8) & 0xFFFF) ^ table[((want >> 8) ^ data[:, k])
                                                  & 0xFF]
        got = macm.crc16(torch.from_numpy(data).to(dev)).cpu().numpy()
        check(np.array_equal(got, want), f"mac: crc16 differs from the table "
              f"walk at n = {n}")
    say("mac", f"crc16 (matrix form) on the card equals the table walk in "
        f"numpy at lengths {lengths}, 64 rows each")

    # no host synchronisation in one write and one read_soft
    cfg = ModemConfig()
    mac = macm.Mac(frame_bytes=cfg.frame_bytes, spread=cfg.mod_type)
    payload = torch.from_numpy(rng.integers(
        0, 256, (B, mac.payload), dtype=np.uint8)).to(dev)
    seq = torch.arange(B, device=dev)
    diag = torch.randn(B, mac.logical_bytes * 8, device=dev)
    wire = mac.write(payload, seq)
    mac.read_soft(diag)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        wire2 = mac.write(payload, seq)
        frame = mac.read_soft(diag)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(torch.equal(wire, wire2) and frame.valid.shape == (B,),
          "mac: the runs under sync debug mode differ")
    say("mac", f"one write and one read_soft at B={B} ran under "
        f"set_sync_debug_mode('error') with no host synchronisation")

    # launches and device time per call at the stock config
    body = torch.cat([wire[:, :6], payload], dim=-1)
    check(torch.equal(crc16_scan(body), macm.crc16(body)),
          "mac: the table walk and the matrix form disagree")
    short = body[:, :64].contiguous()
    counts = {}
    for label, fn, reps in (
            ("write", lambda i: mac.write(payload, seq), 20),
            ("read_soft", lambda i: mac.read_soft(diag), 20),
            (f"crc16 [{B},{body.shape[1]}] (matrix form)",
             lambda i: macm.crc16(body), 20),
            (f"crc16 [{B},64] (matrix form)", lambda i: macm.crc16(short), 20),
            (f"crc16 [{B},{body.shape[1]}] table walk (rejected: one step "
             f"per byte)", lambda i: crc16_scan(body), 3)):
        ms, kernels, wall = profile_call(fn, reps)
        counts[label] = kernels
        say("mac", f"{label} at B={B}, stock config: {kernels:.0f} CUDA "
            f"kernels per call, device {ms * 1e3:.2f} us per call "
            f"(torch.profiler over {reps} calls), wall {wall * 1e3:.1f} us "
            f"per call with host dispatch (CUDA events)")
    check(counts[f"crc16 [{B},64] (matrix form)"]
          == counts[f"crc16 [{B},{body.shape[1]}] (matrix form)"],
          f"mac: crc16's kernel count grows with the byte count {counts}")


LINK_SETS = (   # tests/test_mac_channel.py:64-103, 64 frames each
    dict(snr_db=25.0, cfo=0.0, timing_offset=0),
    dict(snr_db=20.0, cfo=3e-4, timing_offset=1234),
    dict(snr_db=15.0, cfo=-2e-4, timing_offset=4096, quantize_mult="mult",
         amplitude=80.0),
    dict(snr_db=25.0, cfo=1e-4, timing_offset=500, multipath=(0.15 + 0.1j,),
         amplitude=50.0),
)
LINK_EXTRA = 4096 + 2048   # every capture is frame_len + LINK_EXTRA samples


def link_params(cfg):
    """The four ChannelParams of LINK_SETS at one capture length."""
    from c_ofdm_tpu_torch.channel.sim import ChannelParams
    out = []
    for kw in LINK_SETS:
        kw = dict(kw, capture_len=cfg.frame_len + LINK_EXTRA)
        if kw.get("quantize_mult") == "mult":
            kw["quantize_mult"] = cfg.mult
        out.append(ChannelParams(**kw))
    return out


def link_receive(step, mac, caps):
    """receive_batch (FlagshipStep.receive) then read_soft of each row's
    re+im metric: (RxResult, SyncResult, MacFrame)."""
    res, s = step.receive(caps)
    return res, s, mac.read_soft(res.constellation.real
                                 + res.constellation.imag)


def run_link_batch(dev):
    """Phase 21: payload bytes -> Mac.write -> transmit -> apply_channel ->
    receive_batch -> read_soft, B = 256 in four channel sets of 64."""
    from c_ofdm_tpu_torch import ModemConfig, make_frame_spec
    from c_ofdm_tpu_torch.channel.sim import apply_channel
    from c_ofdm_tpu_torch.mac.mac import Mac
    from c_ofdm_tpu_torch.models import tx
    from c_ofdm_tpu_torch.models.modem import FlagshipStep
    from c_ofdm_tpu_torch.ops import extract, modulation
    cfg = ModemConfig()
    step = FlagshipStep(make_frame_spec(cfg, torch.complex64, device=dev,
                                        fft_backend="matmul"))
    spec = step.bound_spec()
    mac = Mac(frame_bytes=cfg.frame_bytes, spread=cfg.mod_type)
    rng = np.random.default_rng(SEED + 21)
    payload_np = rng.integers(0, 256, (B, mac.payload), dtype=np.uint8)
    payload = torch.from_numpy(payload_np).to(dev)
    params = link_params(cfg)
    per = B // len(params)
    g = torch.Generator(device=dev).manual_seed(SEED + 21)

    # ---- the main path, counts from 0
    extract.extract_windows.launches = 0
    wire = mac.write(payload, torch.arange(B, device=dev))
    frames = tx.transmit(spec, wire)
    caps = torch.cat([apply_channel(p, frames[i * per:(i + 1) * per],
                                    generator=g)
                      for i, p in enumerate(params)])
    res, s, fr = link_receive(step, mac, caps)
    torch.cuda.synchronize()
    k1 = extract.extract_windows.launches
    check(k1 == 1, f"link-batch: K1 launched {k1} times in one receive")
    want_start = np.repeat([p.timing_offset for p in params], per)
    check(bool(s.found.all()), "link-batch: a frame was not found")
    check(np.array_equal(s.frame_start.cpu().numpy(), want_start),
          "link-batch: frame_start != the set's timing offset")
    check(bool(fr.valid.all()), f"link-batch: {int((~fr.valid).sum())} "
          f"frames fail the CRC")
    check(np.array_equal(fr.seq.cpu().numpy(), np.arange(B)),
          "link-batch: seq differs")
    check(torch.equal(fr.payload, payload), "link-batch: payload differs")
    llr = modulation.soft_llrs(res.constellation, cfg.mod_type)
    fl = mac.read_llr(llr)
    check(bool(fl.valid.all()) and torch.equal(fl.payload, payload)
          and torch.equal(fl.seq, fr.seq),
          "link-batch: read_llr(soft_llrs) gives other frames")
    say("link-batch", f"B={B} MAC frames (payload {mac.payload} bytes, seq "
        f"0..{B - 1}) through transmit, apply_channel in 4 sets of {per} "
        f"({', '.join(f'{p.snr_db:g} dB cfo {p.cfo:g} timing '
                      f'{p.timing_offset}' for p in params)}; captures "
        f"{tuple(caps.shape)}) and receive_batch: every frame found at its "
        f"set's timing offset, read_soft payloads and seq exact with the "
        f"CRC valid, read_llr(soft_llrs) the same; K1 launches {k1}")

    # ---- one set with phi0 and noise drawn on the CPU: card == CPU run
    p = params[1]
    n = caps.shape[-1]
    gc = torch.Generator().manual_seed(SEED + 22)
    phi0 = torch.rand(per, generator=gc) * (2 * np.pi)
    noise = torch.randn(per, n, 2, generator=gc)
    rows = slice(per, 2 * per)
    cap_d = apply_channel(p, frames[rows], phi0=phi0.to(dev),
                          noise=noise.to(dev))
    res_d, s_d, fr_d = link_receive(step, mac, cap_d)
    cpu_step = FlagshipStep(make_frame_spec(cfg, torch.complex64,
                                            device="cpu",
                                            fft_backend="matmul"))
    wire_c = mac.write(payload.cpu()[rows], torch.arange(per, 2 * per))
    cap_c = apply_channel(p, tx.transmit(cpu_step.bound_spec(), wire_c),
                          phi0=phi0, noise=noise)
    res_c, s_c, fr_c = link_receive(cpu_step, mac, cap_c)
    err = float((cap_d.cpu() - cap_c).abs().max() / cap_c.abs().max())
    for name in ("frame_start", "t2_begin", "pr_begin", "found"):
        check(torch.equal(getattr(s_d, name).cpu(), getattr(s_c, name)),
              f"link-batch: {name} differs from the CPU run")
    # the raw PHY bytes are hard QAM decisions: at 20 dB some symbols lie
    # within float32 rounding of a decision boundary, so they are counted
    # here, not required equal (the MAC frames below are)
    raw = int((res_d.mac_bytes.cpu() != res_c.mac_bytes).sum())
    for name, a, b in zip(fr_c._fields, fr_c, fr_d):
        check(torch.equal(a, b.cpu()), f"link-batch: MacFrame {name} "
              f"differs from the CPU run")
    check(bool(fr_c.valid.all()) and torch.equal(fr_c.payload,
                                                 payload.cpu()[rows]),
          "link-batch: the CPU run does not decode the set")
    say("link-batch", f"set 2 ({p.snr_db:g} dB, cfo {p.cfo:g}, timing "
        f"{p.timing_offset}) with phi0 and noise drawn on the CPU: captures "
        f"within {err:.2e} of max|x| of the CPU run; sync and every "
        f"MacFrame field (payload, ids, seq, valid) equal to the port's CPU "
        f"run; raw PHY bytes that differ: {raw} of "
        f"{res_c.mac_bytes.numel()}")

    for i, p in enumerate(params):
        x = frames[i * per:(i + 1) * per]
        ms, kernels, wall = profile_call(
            lambda j, p=p, x=x: apply_channel(p, x, generator=g), 10)
        say("link-batch", f"apply_channel set {i + 1} at [{per}, "
            f"{cfg.frame_len}] -> [{per}, {n}]: device {ms * 1e3:.2f} us in "
            f"{kernels:.0f} CUDA kernels per call (torch.profiler over 10), "
            f"wall {wall * 1e3:.1f} us per call (CUDA events)")


def stream_mac_frames(mac, outs, C):
    """read_soft of every valid slot's diag, per channel in stream order:
    lists of (seq, payload, valid)."""
    got = [[] for _ in range(C)]
    for out in outs:
        fr = mac.read_soft(out.diag)
        valid = out.valid.cpu().numpy().reshape(C, -1)
        seq = fr.seq.cpu().numpy().reshape(C, -1)
        ok = fr.valid.cpu().numpy().reshape(C, -1)
        pl = fr.payload.cpu().numpy().reshape(C, valid.shape[1], -1)
        for c in range(C):
            for k in np.flatnonzero(valid[c]):
                got[c].append((int(seq[c, k]), pl[c, k], bool(ok[c, k])))
    return got


def run_link_stream(dev):
    """Phase 22: the streaming link loop on bench.py's MAC-framed rings at
    C = 1 and 8, then the +-20 ppm sample-clock stream."""
    from c_ofdm_tpu_torch import ModemConfig, make_frame_spec
    from c_ofdm_tpu_torch.channel.sim import ChannelParams, apply_channel
    from c_ofdm_tpu_torch.mac.mac import Mac
    from c_ofdm_tpu_torch.models import streaming, tx
    from c_ofdm_tpu_torch.ops import extract
    cfg = ModemConfig()
    spec = make_frame_spec(cfg, torch.complex64, device=dev,
                           fft_backend="matmul")
    mac = Mac(frame_bytes=cfg.frame_bytes, spread=cfg.mod_type)
    kernels = {1: extract.extract_windows_single,
               8: extract.extract_windows_multi}
    for C, fn in kernels.items():
        blocks, truth, payload = streaming_buffers(spec, C, SEED + 30 + C,
                                                   mac=mac)
        rxr = streaming.StreamingReceiver(spec, channels=0 if C == 1 else C)
        torch.cuda.synchronize()
        # ---- the main path, counts from 0
        for f in (extract.extract_windows, *kernels.values()):
            f.launches = 0
        per_buf, outs = [], []
        for blk in blocks:
            before = fn.launches
            outs.append(rxr.feed(blk))
            per_buf.append(fn.launches - before)
        torch.cuda.synchronize()
        other = [f.launches for f in (extract.extract_windows,
                                      *kernels.values()) if f is not fn]
        check(per_buf == [2] * S and not any(other),
              f"link-stream C={C}: launches per buffer {per_buf}, others "
              f"{other}")
        n_frames = check_truth(spec, outs, truth, C)
        got = stream_mac_frames(mac, outs, C)
        for c in range(C):
            want = len(truth[c])
            check([g[0] for g in got[c]] == list(range(want)),
                  f"link-stream C={C} channel {c}: seq "
                  f"{[g[0] for g in got[c]]}")
            check(all(ok for _, _, ok in got[c]),
                  f"link-stream C={C} channel {c}: a CRC fails")
            check(all(np.array_equal(pl, payload[c, i])
                      for i, (_, pl, _) in enumerate(got[c])),
                  f"link-stream C={C} channel {c}: a payload differs")
        say("link-stream", f"C={C}: {S} buffers of bench.py's MAC-framed "
            f"rings, {n_frames} planted frames decoded exactly once, in "
            f"order, at their planted starts; read_soft of every valid slot: "
            f"seq 0.. in order, payloads exact, CRC valid; "
            f"{'K2' if C == 1 else 'K3'} launches per buffer {per_buf}")

    # ---- +-20 ppm sample clock (tests/test_mac_channel.py:106-142)
    n_frames = 12
    rng = np.random.default_rng(7)
    buf = cfg.rx_buf_size * cfg.frame_len
    for ppm in (20.0, -20.0):
        payload = torch.from_numpy(rng.integers(
            0, 256, (n_frames, mac.payload), dtype=np.uint8)).to(dev)
        frames = tx.transmit(spec, mac.write(
            payload, torch.arange(n_frames, device=dev)))
        stream = torch.cat([torch.zeros(900, dtype=frames.dtype, device=dev),
                            frames.reshape(-1)])
        total = -(-stream.shape[0] // buf) * buf
        params = ChannelParams(snr_db=24.0, cfo=1.5e-4, sco_ppm=ppm,
                               capture_len=total, amplitude=60.0)
        cap = apply_channel(params, stream, generator=torch.Generator(
            device=dev).manual_seed(3))
        rxr = streaming.StreamingReceiver(spec, max_frames=16)
        extract.extract_windows_single.launches = 0
        outs = [rxr.feed(cap[i * buf:(i + 1) * buf])
                for i in range(total // buf)]
        torch.cuda.synchronize()
        k2 = extract.extract_windows_single.launches
        check(k2 == 2 * len(outs), f"link-stream sco {ppm:+g} ppm: K2 "
              f"launched {k2} times in {len(outs)} buffers")
        got = stream_mac_frames(mac, outs, 1)[0]
        check(len(got) == n_frames, f"link-stream sco {ppm:+g} ppm: decoded "
              f"{len(got)} of {n_frames}")
        for i, (seq, pl, ok) in enumerate(got):
            check(seq == i and ok and np.array_equal(
                pl, payload[i].cpu().numpy()),
                  f"link-stream sco {ppm:+g} ppm: frame {i} (seq {seq}, "
                  f"valid {ok})")
        say("link-stream", f"sco {ppm:+g} ppm stream ({n_frames} frames, "
            f"24 dB, cfo 1.5e-4, amplitude 60, {tuple(cap.shape)} samples "
            f"through apply_channel on the card): all {n_frames} frames "
            f"CRC-clean, in order, payloads exact; K2 launches {k2} in "
            f"{len(outs)} buffer(s)")


def _app(mod, argv):
    """(exit code, stdout) of an app's main(argv), run in-process."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = mod.main([str(a) for a in argv])
    return rc, out.getvalue()


def _rx_app(d, tag, src, device, *extra):
    """The rx app on ``src`` -> (decoded bytes, metrics rows, summary)."""
    from c_ofdm_tpu_torch.apps import rxstream
    rc, _ = _app(rxstream, ["--in", src, "--format", "i16",
                            "--out", d / f"{tag}_decoded.bin",
                            "--metrics", d / f"{tag}.jsonl",
                            "--log", d / f"{tag}_LOG.txt",
                            "--summary-json", d / f"{tag}.json",
                            "--device", device, *extra])
    check(rc == 0, f"apps: rx {tag} exited {rc}")
    rows = [json.loads(ln) for ln in
            (d / f"{tag}.jsonl").read_text().splitlines()]
    return ((d / f"{tag}_decoded.bin").read_bytes(), rows,
            json.loads((d / f"{tag}.json").read_text()))


def same_rows(a, b, tag):
    check(len(a) == len(b), f"apps: {tag}: {len(a)} rows against {len(b)}")
    for g, w in zip(a, b):
        check(all(g[k] == w[k] for k in ("buf", "slot", "pos", "seq",
                                          "crc_ok"))
              and abs(g["cfo"] - w["cfo"]) <= 1e-5,
              f"apps: {tag}: row {g} against {w}")


def run_apps(dev, card):
    """Phase 23: the port's CLI (python -m c_ofdm_tpu_torch tx / rx /
    loopback / ber-sweep / ingest-bench) on the card, in-process through
    each app's main(argv), with the launch counts of K1 and K2 set to 0
    before each run that reads them."""
    from pathlib import Path
    from c_ofdm_tpu_torch import ModemConfig
    from c_ofdm_tpu_torch.apps import (ber_sweep, ingest_bench, loopback,
                                       txstream)
    from c_ofdm_tpu_torch.ops import extract
    t0 = time.perf_counter()
    cfg = ModemConfig()
    buf = cfg.rx_buf_size * cfg.frame_len
    k2 = extract.extract_windows_single
    build = Path(__file__).resolve().parent / "c_ofdm_tpu_torch" / "_build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        d = Path(tmp)
        # ---- tx -> file -> rx, the main path of the CLI
        payload = (b"The quick brown fox jumps over the lazy dog. " * 40)[:1200]
        (d / "payload.bin").write_bytes(payload)
        rc, _ = _app(txstream, ["--in", d / "payload.bin", "--out",
                                d / "stream.bin", "--gap", 500,
                                "--device", dev])
        check(rc == 0, f"apps: tx exited {rc}")
        torch.cuda.synchronize()
        k2.launches = 0
        full, rows, summ = _rx_app(d, "full", d / "stream.bin", dev)
        torch.cuda.synchronize()
        launches = k2.launches
        check(payload in full[:len(payload) + 16],
              "apps: the payload is not in decoded.bin")
        check(len(rows) == 5 and all(r["crc_ok"] for r in rows)
              and [r["seq"] for r in rows] == list(range(len(rows))),
              f"apps: metrics rows {rows}")
        check(launches == 2 * summ["buffers"] and summ["buffers"] >= 1,
              f"apps: K2 launched {launches} times in {summ['buffers']} "
              f"buffer(s)")
        check("RX_STEP" in (d / "full_LOG.txt").read_text(),
              "apps: LOG.txt has no RX_STEP")
        say("apps", f"tx -> rx: {summ['frames']} frames of a 1200-byte "
            f"payload (gap 500), payload in decoded.bin, every metrics row "
            f"CRC-clean with seq 0..{len(rows) - 1}; K2 launches {launches} "
            f"in {summ['buffers']} buffer(s)")

        # ---- the metadata drains tally what the full drain decoded
        pl = np.frombuffer(full, dtype=np.uint8).reshape(len(rows), -1)
        ok = np.array([r["crc_ok"] for r in rows])
        want = {"frames": len(rows), "crc_failures": int((~ok).sum()),
                "max_seq": max(r["seq"] for r in rows if r["crc_ok"]),
                "payload_checksum_u32":
                    int(pl[ok].astype(np.int64).sum()) & 0xFFFFFFFF}
        for chunk in (1, 2):
            _, _, sm = _rx_app(d, f"meta{chunk}", d / "stream.bin", dev,
                               "--drain", "metadata", "--chunk", chunk)
            got = {k: sm[k] for k in want}
            check(got == want, f"apps: --drain metadata --chunk {chunk}: "
                  f"{got} against the full drain's {want}")
            check((d / f"meta{chunk}_decoded.bin").stat().st_size == 0,
                  f"apps: --drain metadata --chunk {chunk} wrote payloads")
        say("apps", f"--drain metadata, --chunk 1 and 2: {want}, equal to "
            f"the full drain; --out empty")

        # ---- native ingest: the replay ring loops the file, so it is held
        # against a file holding what the replay yields
        raw = np.fromfile(d / "stream.bin", dtype=np.int16)
        n_bufs = (d / "stream.bin").stat().st_size // (buf * 4) + 1
        np.resize(raw, n_bufs * buf * 2).tofile(d / "replay.bin")
        nat = _rx_app(d, "native", d / "stream.bin", dev, "--native-ingest")
        rep = _rx_app(d, "replay", d / "replay.bin", dev)
        check(nat[0] == rep[0] and payload in nat[0],
              "apps: --native-ingest decoded other bytes than the replayed "
              "file")
        same_rows(nat[1], rep[1], "--native-ingest")
        say("apps", f"--native-ingest: {nat[2]['frames']} frames in "
            f"{nat[2]['buffers']} buffer(s) of the looped file, bytes and "
            f"rows equal to rx of the file the replay yields")

        # ---- the card against the CPU on the same file
        cpu = _rx_app(d, "cpu", d / "stream.bin", "cpu")
        check(cpu[0] == full, "apps: decoded bytes differ from the CPU run")
        same_rows(rows, cpu[1], "card against CPU")
        say("apps", f"card = CPU: decoded bytes equal, {len(rows)} metrics "
            f"rows equal (cfo within 1e-5)")

        # ---- a longer stream: 738 MAC frames, 20 stock buffers
        n_long = 738
        long_payload = np.random.default_rng(SEED + 23).integers(
            0, 256, n_long * 248, dtype=np.uint8).tobytes()
        (d / "long.bin").write_bytes(long_payload)
        rc, _ = _app(txstream, ["--in", d / "long.bin", "--out",
                                d / "long_stream.bin", "--gap", 500,
                                "--device", dev])
        check(rc == 0, f"apps: tx of the long stream exited {rc}")
        torch.cuda.synchronize()
        k2.launches = 0
        got, lrows, ls = _rx_app(d, "long", d / "long_stream.bin", dev)
        torch.cuda.synchronize()
        check(ls["buffers"] == 20 and k2.launches == 40,
              f"apps: long stream: {ls['buffers']} buffers, K2 launched "
              f"{k2.launches} times")
        check(got == long_payload and ls["crc_failures"] == 0
              and [r["seq"] for r in lrows] == list(range(n_long)),
              f"apps: long stream: {ls['frames']} frames, "
              f"{ls['crc_failures']} CRC failures")
        mbytes = (d / "long_stream.bin").stat().st_size / 1e6
        say("apps", f"long stream ({mbytes:.2f} MB of int16, "
            f"{ls['buffers']} buffers, {n_long} frames, all exact, K2 "
            f"launches {k2.launches}) on {card}: steady_samples_per_s "
            f"{ls['steady_samples_per_s']}, samples_per_s "
            f"{ls['samples_per_s']}, wall_s {ls['wall_s']}, host_feed_s "
            f"{ls['host_feed_s']}, device_drain_s {ls['device_drain_s']}, "
            f"feed_bound {ls['feed_bound']}")
        # the same run again under torch.profiler: the card's share of it
        from torch.autograd import DeviceType
        dev_ms, events = device_ms(
            lambda i: _rx_app(d, "long_prof", d / "long_stream.bin", dev), 1)
        n_k = sum(e.count for e in events
                  if e.device_type == DeviceType.CUDA) / ls["buffers"]
        per_buf = ls["wall_s"] * 1e3 / ls["buffers"]
        say("apps", f"long stream under torch.profiler: device time "
            f"{dev_ms / ls['buffers']:.4f} ms per buffer in {n_k:.0f} "
            f"kernels (kernel sum over the run's {ls['buffers']} buffers); "
            f"against the unprofiled run's {per_buf:.4f} ms of wall per "
            f"buffer: device idle {1 - dev_ms / (ls['wall_s'] * 1e3):.1%}")

        # ---- loopback, K1 once per call
        for f64 in (False, True):
            extract.extract_windows.launches = 0
            rc, out = _app(loopback, ["--snr-db", 28, "--dump", d / "lb",
                                      "--device", dev]
                           + (["--f64"] if f64 else []))
            torch.cuda.synchronize()
            k1 = extract.extract_windows.launches
            check(rc == 0 and "ACCURACY: 1.0" in out.splitlines(),
                  f"apps: loopback {'c128' if f64 else 'c64'} exited {rc}: "
                  f"{out}")
            check(k1 == 1, f"apps: loopback launched K1 {k1} times")
            evm = [ln for ln in out.splitlines() if ln.startswith("EVM")]
            say("apps", f"loopback {'c128' if f64 else 'c64'} at 28 dB: "
                f"ACCURACY: 1.0, exit 0, {evm[0]}, K1 launches {k1}")

        # ---- ber-sweep
        rc, _ = _app(ber_sweep, ["--mods", 4, "--snrs", "12:29:8",
                                 "--frames", 4, "--out", d / "ber.jsonl",
                                 "--device", dev])
        ber = [json.loads(ln) for ln in
               (d / "ber.jsonl").read_text().splitlines()]
        evms = [r["evm_rms"] for r in ber]
        check(rc == 0 and [r["snr_db"] for r in ber] == [12.0, 20.0, 28.0]
              and ber[-1]["ber"] == 0.0 and evms == sorted(evms, reverse=True),
              f"apps: ber-sweep rows {ber}")
        say("apps", f"ber-sweep QAM16 at 12/20/28 dB: EVM {evms}, BER "
            f"{[r['ber'] for r in ber]}")

        # ---- ingest-bench
        rc, out = _app(ingest_bench, ["--buffers", 50, "--to-device"])
        line = json.loads(out.strip().splitlines()[-1])
        check(rc == 0 and line["metric"] == "ingest_samples_per_s_to_device",
              f"apps: ingest-bench printed {out}")
        say("apps", f"ingest-bench --buffers 50 --to-device on {card}: "
            f"{json.dumps(line)}")
    say("apps", f"phase took {time.perf_counter() - t0:.1f} s")
    return {"launches_k2": launches, "long": ls}


# ---- 24: parallel/ (the sharded receiver, the channel-sharded stream)

DRY_BLOCK = 40     # frame lengths per time block: the stock buffer
DRY_FILL = 5 / 6   # frames per frame length (__graft_entry__.py: 5 in 6)
RANKS_GLOO = (2, 2)


def dryrun_captures(spec, mac, C, n_time, block_len, rng):
    """``__graft_entry__.py:65-205``'s dryrun_multichip capture, rebuilt from
    a numpy seed: per channel MAC frames (``Mac.write`` with seq 0, 1, ...,
    ``transmit`` on the spec's device) at random gaps, amplitudes 40 x
    U(0.6, 1.0), CFO 1e-4, AWGN at 30 dB (at amplitude 40), and one near-gate
    spurious two-tone burst in each channel's widest gap.  One frame per
    channel straddles each time boundary, and the last frame ends exactly
    at the capture end.  Returns (captures [C, total] complex64 numpy, per
    channel the planted (start, wire bytes) in order, per channel the
    payloads)."""
    from c_ofdm_tpu_torch.models import tx
    cfg = spec.cfg
    fl = cfg.frame_len
    total = n_time * block_len
    starts = []
    for _ in range(C):
        forced = [b * block_len - int(rng.integers(fl // 4, 3 * fl // 4))
                  for b in range(1, n_time)]
        los = [0] + [s + fl for s in forced]
        his = forced + [total]
        ch = []
        for j, (lo, hi) in enumerate(zip(los, his)):
            k = int(DRY_FILL * (hi - lo) / fl)
            last = j == len(forced)
            # the last segment's trailing gap is 0: its last frame ends at
            # the capture end
            gaps = rng.multinomial(hi - lo - k * fl,
                                   np.ones(k + (not last)) / (k + (not last)))
            pos = lo
            for i in range(k):
                pos += int(gaps[i])
                ch.append(pos)
                pos += fl
            ch.extend(forced[j:j + 1])
        starts.append(ch)
    payloads = [rng.integers(0, 256, (len(s), mac.payload), dtype=np.uint8)
                for s in starts]
    wire = mac.write(torch.from_numpy(np.concatenate(payloads)).to(
        spec.device), torch.from_numpy(np.concatenate(
            [np.arange(len(s)) for s in starts])).to(spec.device))
    frames = tx.transmit(spec, wire).cpu().numpy().astype(np.complex128)
    wire = wire.cpu().numpy()
    caps = np.zeros((C, total), np.complex128)
    truth, i = [], 0
    for c in range(C):
        truth.append([])
        for s in starts[c]:
            caps[c, s:s + fl] = frames[i] * 40.0 * (0.6 + 0.4 * rng.random())
            truth[c].append((s, wire[i]))
            i += 1
    caps *= np.exp(2j * np.pi * 1e-4 * np.arange(total))[None, :]
    noise_std = np.sqrt(float((np.abs(frames) ** 2).mean()) * 40.0 ** 2
                        * 10 ** (-30.0 / 10) / 2)
    burst = frames[0, :cfg.t2sin_size]
    sp_scale = np.sqrt(1.33 * 2 * noise_std ** 2
                       / float((np.abs(burst) ** 2).mean()))
    for c in range(C):
        ends = [0] + [s + fl for s in starts[c]]
        lo, hi = max(zip(ends, starts[c] + [total]), key=lambda g: g[1] - g[0])
        s = min((lo + hi) // 2, total - cfg.t2sin_size)
        caps[c, s:s + cfg.t2sin_size] += sp_scale * burst
    caps += noise_std * (rng.standard_normal(caps.shape)
                         + 1j * rng.standard_normal(caps.shape))
    return caps.astype(np.complex64), truth, payloads


def check_sharded(spec, mac, out, truth, payloads, block_len, tag):
    """The gathered view [C, n_time, K] (numpy fields) against the planted
    truth: every frame decoded exactly once at its planted start +
    t2sin_size with exact bytes, read_soft giving its seq and payload with
    the CRC valid, and nothing else (the spurious bursts).  Returns the
    number of frames and of halo-straddling frames."""
    cfg = spec.cfg
    n_time = out["valid"].shape[1]
    gpos = out["positions"] + (np.arange(n_time) * block_len)[None, :, None]
    n_frames = n_straddle = 0
    for c, want in enumerate(truth):
        v = out["valid"][c]
        got = sorted((int(p), bytes(b)) for p, b in
                     zip(gpos[c][v], out["mac_bytes"][c][v]))
        check(got == sorted((s + cfg.t2sin_size, bytes(w)) for s, w in want),
              f"{tag}: channel {c} decoded {[p for p, _ in got]}, planted "
              f"{[s + cfg.t2sin_size for s, _ in want]}")
        fr = mac.read_soft(torch.from_numpy(out["diag"][c][v]))
        seq = fr.seq.numpy()
        check(bool(fr.valid.all()) and sorted(seq) == list(range(len(want)))
              and all(np.array_equal(p, payloads[c][q]) for p, q in
                      zip(fr.payload.numpy(), seq)),
              f"{tag}: channel {c}: read_soft seq {sorted(seq)}, CRC valid "
              f"{fr.valid.tolist()}")
        n_frames += len(want)
        n_straddle += sum(s % block_len > block_len - cfg.frame_len
                          for s, _ in want)
    return n_frames, n_straddle


def _np_out(out):
    return {k: v.cpu().numpy() for k, v in out._asdict().items()}


def _stream_out(d):
    from c_ofdm_tpu_torch.models.streaming import StreamOut
    return StreamOut(**{k: torch.from_numpy(v) for k, v in d.items()})


def run_parallel(dev, card):
    """Phase 24: parallel/ on the card.  (a) a world of one in this process
    (NCCL group of size 1): the sharded receiver at C = 8 x 240 640, every
    dryrun frame exact, equal to the CPU run, K3 twice; timing; pallas.
    (b) 4 gloo ranks on cuda:0, mesh {channel: 2, time: 2}: the halo through
    host memory, equal to the truth and to process_buffer over the whole
    capture.  (c) the channel-sharded stream in a gloo world of 2 on cuda:0
    against StreamingReceiver(channels=8).  (d) the scaling-bench app."""
    import socket
    import torch.distributed as dist
    from c_ofdm_tpu_torch import ModemConfig, make_frame_spec
    from c_ofdm_tpu_torch.apps import scaling_bench
    from c_ofdm_tpu_torch.mac.mac import Mac
    from c_ofdm_tpu_torch.models import streaming
    from c_ofdm_tpu_torch.ops import dft, extract
    from c_ofdm_tpu_torch.parallel import ingest, launch, mesh, sharded
    t0 = time.perf_counter()
    cfg = ModemConfig()
    fl = cfg.frame_len
    spec = make_frame_spec(cfg, torch.complex64, device=dev,
                           fft_backend="matmul")
    mac = Mac(frame_bytes=cfg.frame_bytes, spread=cfg.mod_type)
    rng = np.random.default_rng(SEED + 24)
    block_len = DRY_BLOCK * fl
    max_pb = DRY_BLOCK + 1
    gathers = (extract.extract_windows, extract.extract_windows_single,
               extract.extract_windows_multi)
    k3_launches = 0

    # ---- (a) world of one: the CPU reference first, without a group
    C = STATE_C
    caps, truth, payloads = dryrun_captures(spec, mac, C, 1, block_len, rng)
    cpu_spec = make_frame_spec(cfg, torch.complex64, device="cpu",
                               fft_backend="matmul")
    cpu_mesh = mesh.make_modem_mesh(1, 1, device="cpu")
    cpu_out = sharded.gather_outputs(cpu_mesh, sharded.make_sharded_receiver(
        cpu_spec, cpu_mesh, max_pb)(ingest.make_global_capture(cpu_mesh,
                                                               caps)))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        m = mesh.make_modem_mesh(1, 1, device=dev)
        check(m.group is not None and not m.staged
              and dist.get_backend(m.group) == "nccl",
              f"parallel: the world of one is not an NCCL group: {m}")
        recv = sharded.make_sharded_receiver(spec, m, max_pb)
        block = ingest.make_global_capture(m, caps)
        torch.cuda.synchronize()
        # ---- the main path, counts from 0
        for f in (*gathers, dft.dft):
            f.launches = 0
        out = sharded.gather_outputs(m, recv(block))
        torch.cuda.synchronize()
        counts = [f.launches for f in (*gathers, dft.dft)]
        check(counts == [0, 0, 2, 0], f"parallel (a): (K1, K2, K3, K4) "
              f"launches {counts}, want (0, 0, 2, 0)")
        k3_launches += counts[2]
        n_frames, _ = check_sharded(spec, mac, _np_out(out), truth, payloads,
                                    block_len, "parallel (a)")
        same_outputs([out], [cpu_out], "parallel (a) card against CPU",
                     atol=1e-4)
        ms = cuda_ms(lambda i: recv(block), 20)
        dev_ms, _ = device_ms(lambda i: recv(block), 10)
        say("parallel", f"(a) world of one, NCCL group of 1 on {dev}: "
            f"sharded receiver {{channel:1, time:1}}, C={C} x {block_len} "
            f"(dryrun capture: CFO 1e-4, 30 dB, random gaps, amplitudes "
            f"40 x 0.6-1.0, a near-gate spurious burst per channel), "
            f"max_frames_per_block {max_pb}: {n_frames} planted frames "
            f"decoded exactly once at start + t2sin_size, bytes exact, CRC "
            f"valid, no spurious decode; every field equal to the CPU run; "
            f"(K1, K2, K3, K4) launches {counts}")
        say("parallel", f"(a) on {card}: {ms:.4f} ms per call (CUDA events, "
            f"20 calls), device {dev_ms:.4f} ms (torch.profiler), "
            f"{C * block_len / (ms * 1e-3):.6g} samples/s, idle "
            f"{1 - dev_ms / ms:.1%}")
        # pallas: K4 once per call (demod_sig's one bins_transform of the
        # C x 41 x 9 symbols), K3 twice
        recv_p = sharded.make_sharded_receiver(
            make_frame_spec(cfg, torch.complex64, device=dev,
                            fft_backend="pallas"), m, max_pb)
        before = [dft.dft.radix_launches, dft.dft.dense_launches,
                  extract.extract_windows_multi.launches]
        out_p = _np_out(sharded.gather_outputs(m, recv_p(block)))
        torch.cuda.synchronize()
        got = [dft.dft.radix_launches - before[0],
               dft.dft.dense_launches - before[1],
               extract.extract_windows_multi.launches - before[2]]
        check(got == [1, 0, 2], f"parallel (a) pallas: (radix K4, dense K4, "
              f"K3) launches {got}, want (1, 0, 2)")
        check_sharded(spec, mac, out_p, truth, payloads, block_len,
                      "parallel (a) pallas")
        say("parallel", f"(a) under fft_backend='pallas': the same "
            f"{n_frames} frames exact; (radix K4, dense K4, K3) launches "
            f"{got}")
    finally:
        dist.destroy_process_group()

    # ---- (b) 4 gloo ranks on cuda:0, {channel: 2, time: 2}, and (c) the
    # channel-sharded stream's 2 gloo ranks on cuda:0, both worlds at once
    # (spawning a rank dominates their time)
    from concurrent.futures import ThreadPoolExecutor
    nc, nt = RANKS_GLOO
    C = 2 * nc
    caps, truth, payloads = dryrun_captures(spec, mac, C, nt, block_len, rng)
    blocks, s_truth, _ = streaming_buffers(spec, STATE_C, SEED + 30 + STATE_C,
                                           mac=mac)
    t1 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        world_b = pool.submit(
            launch.run_world, nc * nt,
            "c_ofdm_tpu_torch.parallel.launch:receive_rank", backend="gloo",
            device=str(dev),
            args=(cfg, torch.complex64, "matmul", caps, nc, nt, max_pb),
            timeout=300)
        world_c = pool.submit(
            launch.run_world, 2,
            "c_ofdm_tpu_torch.parallel.launch:stream_rank", backend="gloo",
            device=str(dev), args=(cfg, torch.complex64, "matmul",
                                   blocks.cpu().numpy(), 2, 1, 0),
            timeout=300)
        ranks, ranks_c = world_b.result(), world_c.result()
    secs = time.perf_counter() - t1
    for r, res in enumerate(ranks):
        check(res["coords"] == divmod(r, nt) and res["launches"] == {
            "K1": 0, "K2": 0, "K3": 2, "K4": 0},
            f"parallel (b): rank {r} at {res['coords']}, launches "
            f"{res['launches']}")
        for k, v in res["out"].items():
            check(np.array_equal(v, ranks[0]["out"][k], equal_nan=True),
                  f"parallel (b): rank {r}'s gathered {k} differs")
        k3_launches += res["launches"]["K3"]
    out = ranks[0]["out"]
    n_frames, n_straddle = check_sharded(spec, mac, out, truth, payloads,
                                         block_len, "parallel (b)")
    check(n_straddle >= C * (nt - 1), f"parallel (b): {n_straddle} "
          f"halo-straddling frames decoded, want >= {C * (nt - 1)}")
    # the dryrun's single-device reference: the whole capture as one buffer
    _, ref = streaming.process_buffer(
        spec, streaming.init_state(spec, channels=C),
        torch.from_numpy(caps).to(dev),
        max(len(t) for t in truth) + 2)
    ref = _np_out(ref)
    for c in range(C):
        v = ref["valid"][c]
        single = sorted((int(p) - fl, bytes(b)) for p, b in
                        zip(ref["positions"][c][v], ref["mac_bytes"][c][v]))
        gpos = out["positions"][c] + (np.arange(nt) * block_len)[:, None]
        vv = out["valid"][c]
        got = sorted((int(p), bytes(b)) for p, b in
                     zip(gpos[vv], out["mac_bytes"][c][vv]))
        check(single == got, f"parallel (b): channel {c}: the sharded "
              f"decode differs from process_buffer over the whole capture")
    say("parallel", f"(b) {nc * nt} gloo ranks on {dev} (every rank on the "
        f"one card, halo staged through host memory), mesh {{channel:{nc}, "
        f"time:{nt}}}, C={C} x {nt * block_len}: {n_frames} planted frames "
        f"exact (incl. {n_straddle} halo-straddling, and each channel's "
        f"last frame ending at the capture end), every rank's gathered view "
        f"equal, equal to process_buffer over the whole capture on the "
        f"card; K3 launches per rank 2")

    # ---- (c) the channel-sharded stream against the unsharded receiver
    C = STATE_C
    rxr = streaming.StreamingReceiver(spec, channels=C)
    want = [_np_out(o) for o in feed_all(rxr, blocks)]
    state = _np_out(rxr.state)
    for r, res in enumerate(ranks_c):
        check(res["launches"] == {"K1": 0, "K2": 0, "K3": 2 * S, "K4": 0},
              f"parallel (c): rank {r} launches {res['launches']}")
        k3_launches += res["launches"]["K3"]
        same_outputs([_stream_out(o) for o in res["outs"]],
                     [_stream_out(o) for o in want],
                     f"parallel (c) rank {r}", atol=1e-4)
        for k, v in state.items():
            check(np.array_equal(res["state"][k], v),
                  f"parallel (c): rank {r}'s final state {k} differs")
    n_frames = check_truth(spec, [_stream_out(o) for o in ranks_c[0]["outs"]],
                           s_truth, C)
    say("parallel", f"(c) channel-sharded stream, 2 gloo ranks on {dev}, "
        f"mesh {{channel:2, time:1}}, C={C} MAC-framed rings (phase 22), "
        f"S={S} buffers from make_global_stream_state: {n_frames} planted "
        f"frames exact; every buffer's gathered output and the final state "
        f"equal to StreamingReceiver(channels={C}) on the card; K3 launches "
        f"per rank {2 * S}; the worlds of (b) and (c) spawned and run "
        f"together in {secs:.1f} s")

    # ---- (d) the app
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc, text = _app(scaling_bench, ["--devices", 1, "--channels", C,
                                        "--frames-per-block", DRY_BLOCK])
    line = json.loads(text.strip().splitlines()[-1])
    check(rc == 0 and line["devices"] == [1]
          and f"({C} frames)" in err.getvalue(),
          f"parallel (d): scaling-bench exited {rc}: {text} {err.getvalue()}")
    say("parallel", f"(d) scaling-bench --devices 1 --channels {C} "
        f"--frames-per-block {DRY_BLOCK} (an NCCL world of 1 on {card}; a "
        f"single card measures no scaling): {json.dumps(line)}; stderr: "
        f"{' | '.join(err.getvalue().strip().splitlines())}")
    if torch.cuda.device_count() == 1:
        try:
            _app(scaling_bench, ["--devices", 2, "--channels", C])
        except ValueError as e:
            check("need 2 devices, have 1" in str(e),
                  f"parallel (d): --devices 2 raised {e!r}")
            say("parallel", f"(d) --devices 2 on one card: ValueError({e})")
        else:
            check(False, "parallel (d): --devices 2 on one card did not "
                  "raise")
    say("parallel", f"phase took {time.perf_counter() - t0:.1f} s")
    return k3_launches


# ---- 25: the compiled paths (utils/graphs.py: one CUDA-graph replay per
# call in place of jax.jit's one program per call)

@contextlib.contextmanager
def eager_calls():
    """Every captured call of the port runs its step eagerly instead, kernel
    by kernel: the body its graph records (the eager side of phase 25's
    comparisons).  The launch counts are put back on exit, so only the
    replays count."""
    from c_ofdm_tpu_torch.utils import graphs
    call = graphs.CapturedCall.__call__
    counts = graphs.launch_counts()
    graphs.CapturedCall.__call__ = (
        lambda self, fn, inputs, restore=(), static=(): fn(*inputs))
    try:
        yield
    finally:
        graphs.CapturedCall.__call__ = call
        torch.cuda.synchronize()
        graphs._set_counts(counts)


def count_names(delta):
    """{wrapper.attribute[class]: n} of a launch-count delta, for printing."""
    return {f"{f.__name__}.{a}" + (f"[{k}]" if k else ""): v
            for (f, a, k), v in sorted(delta.items(),
                                       key=lambda kv: str(kv[0][1:]))}


def launches_of(fn):
    """The launch-count delta of one call of fn()."""
    from c_ofdm_tpu_torch.utils import graphs
    before = graphs.launch_counts()
    fn()
    torch.cuda.synchronize()
    return {k: v - before.get(k, 0) for k, v in graphs.launch_counts().items()
            if v != before.get(k, 0)}


def kernel_names(delta):
    """The device kernels one call's launch-count delta names, with how many
    of each: K1-K3's body by class, K4's route."""
    want = {}
    for (f, attr, k), v in delta.items():
        if attr == "class_launches":
            name = f"extract_{k}_kernel"
        elif attr in ("radix_launches", "dense_launches"):
            name = "fft_kernel" if attr == "radix_launches" else "dft_kernel"
        else:
            continue
        want[name] = want.get(name, 0) + v
    return want


def profiled_names(events, names, reps):
    """Per call, how many device kernels of each name torch.profiler saw."""
    from torch.autograd import DeviceType
    return {n: sum(e.count for e in events
                   if e.device_type == DeviceType.CUDA and n in e.key) / reps
            for n in names}


def max_diff(a, b):
    d = (a.double() - b.double()).abs() if not a.is_complex() else \
        (a.to(torch.complex128) - b.to(torch.complex128)).abs()
    d = d[~torch.isnan(d)]
    return float(d.max()) if d.numel() else 0.0


def compiled_timing(tag, fns, reps=8, prof_reps=4):
    """Eager and graph in turns (eager, graph, graph, eager): per call the
    median wall by CUDA events around each call, the device time (kernel
    sum, torch.profiler) and the idle share.  ``fns`` maps "eager" and
    "graph" to fn(i); the eager turns run under eager_calls().  Returns
    {mode: (wall ms, device ms)} and the graph's profiler events."""
    wall = {k: [] for k in fns}
    devt = {k: [] for k in fns}
    events = None
    for k in ("eager", "graph", "graph", "eager"):
        ctx = eager_calls() if k == "eager" else contextlib.nullcontext()
        with ctx:
            fns[k](0)
            torch.cuda.synchronize()
            wall[k] += [cuda_ms(fns[k], 1) for _ in range(reps)]
            ms, ev = device_ms(fns[k], prof_reps)
            devt[k].append(ms)
        if k == "graph":
            events = ev
    out = {k: (statistics.median(wall[k]), statistics.median(devt[k]))
           for k in fns}
    (we, de), (wg, dg) = out["eager"], out["graph"]
    say("compiled", f"{tag}: eager {we:.4f} ms per call (device {de:.4f} ms, "
        f"idle {1 - de / we:.1%}); graph {wg:.4f} ms per call (device "
        f"{dg:.4f} ms, idle {1 - dg / wg:.1%}); wall graph/eager "
        f"{wg / we:.3f}, device graph/eager {dg / de:.3f} (medians of "
        f"{2 * reps} calls and 2 profiled windows of {prof_reps} calls each)")
    return out, events


def check_replay_counts(tag, eager_fn, graph_fn, events, reps):
    """One eager call's launch counts = one replay's, and the profiler saw
    each kernel they name, as many times per replay."""
    with eager_calls():
        eager = launches_of(eager_fn)
    replay = launches_of(graph_fn)
    check(eager == replay, f"compiled {tag}: launches per replay "
          f"{count_names(replay)} != per eager call {count_names(eager)}")
    want = kernel_names(replay)
    seen = profiled_names(events, want, reps)
    check(all(seen[n] == v for n, v in want.items()),
          f"compiled {tag}: the profiler saw {seen} per replay, the counts "
          f"name {want}")
    return replay, seen


def graph_record(tag, call):
    """Print and return what the captured call's graphs cost."""
    from c_ofdm_tpu_torch.utils import graphs
    recs = list(call.graphs.values())
    check(recs, f"compiled {tag}: no graph was captured")
    for g in recs:
        say("compiled", f"{tag}: graph captured in {g.capture_s:.3f} s "
            f"(warm-up {graphs.WARMUP} eager runs + capture), pool "
            f"{g.pool_bytes / 2**20:.1f} MiB; per call {len(g.static_in)} "
            f"input copy and {g.clone_launches} output clone launches "
            f"beside the replay")
    return recs


def flagship_cell(dev, tag, cfg, backend, batch, rng, jit_check=False):
    """One flagship step: FlagshipStep's graph against the same step run
    eagerly on the same payloads."""
    from c_ofdm_tpu_torch import make_frame_spec
    from c_ofdm_tpu_torch.models import rx, tx
    from c_ofdm_tpu_torch.models.modem import FlagshipStep
    step = FlagshipStep(make_frame_spec(cfg, torch.complex64, device=dev,
                                        fft_backend=backend))
    payloads = [torch.from_numpy(rng.integers(
        0, 256, (batch, cfg.frame_bytes), dtype=np.uint8)).to(dev)
        for _ in range(2)]
    with eager_calls():
        want = [step(p) for p in payloads]
    got = [step(p) for p in payloads]
    torch.cuda.synchronize()
    recs = graph_record(tag, step.graphs)
    worst = 0.0
    for p, (rw, sw), (rg, sg) in zip(payloads, want, got):
        for name in ("frame_start", "t2_begin", "pr_begin", "found"):
            check(torch.equal(getattr(sw, name), getattr(sg, name)),
                  f"compiled {tag}: {name} graph != eager")
        check(torch.equal(rw.mac_bytes, rg.mac_bytes)
              and torch.equal(rg.mac_bytes, p) and bool(sg.found.all()),
              f"compiled {tag}: bytes graph != eager or != payload")
        for name in ("constellation", "chan_est", "cfo"):
            worst = max(worst, max_diff(getattr(rw, name),
                                        getattr(rg, name)))
    if jit_check:
        spec = step.bound_spec()
        res, s = rx.receive_batch_jit(spec, tx.transmit_jit(spec,
                                                            payloads[0]))
        check(torch.equal(res.mac_bytes, got[0][0].mac_bytes)
              and torch.equal(s.pr_begin, got[0][1].pr_begin)
              and max_diff(res.constellation, got[0][0].constellation) == 0,
              f"compiled {tag}: transmit_jit -> receive_batch_jit != the "
              f"step's graph")
    say("compiled", f"{tag}: B={batch} graph = eager: bytes, frame_start, "
        f"t2_begin, pr_begin, found exact (payloads exact); constellation, "
        f"chan_est, cfo max abs diff {worst:.3g}"
        + ("; transmit_jit -> receive_batch_jit = the step's graph"
           if jit_check else ""))
    fns = {m: (lambda i: step(payloads[i % 2])) for m in ("eager", "graph")}
    times, events = compiled_timing(tag, fns)
    replay, seen = check_replay_counts(tag, lambda: step(payloads[0]),
                                       lambda: step(payloads[0]), events, 4)
    say("compiled", f"{tag}: launches per replay = per eager call "
        f"{count_names(replay)}; profiler per replay {seen}")
    return {"tag": tag, "times": times, "launches": count_names(replay),
            "worst": worst, "capture_s": recs[0].capture_s,
            "pool_mib": recs[0].pool_bytes / 2**20}


def stream_cell(dev, tag, spec, blocks, C):
    """S buffers through a StreamingReceiver's graph against the same
    receiver code run eagerly, each from the initial state."""
    from c_ofdm_tpu_torch.models import streaming
    rxe = streaming.StreamingReceiver(spec, channels=0 if C == 1 else C)
    rxg = streaming.StreamingReceiver(spec, channels=0 if C == 1 else C)
    with eager_calls():
        want = [rxe.feed(b) for b in blocks]
    got = [rxg.feed(b) for b in blocks]
    torch.cuda.synchronize()
    recs = graph_record(tag, rxg.graphs)
    worst = {"diag": 0.0, "cfo": 0.0, "carry": 0.0}
    all_bytes = True
    for i, (w, g) in enumerate(zip(want, got)):
        for name in ("positions", "valid", "num_found"):
            check(torch.equal(getattr(w, name), getattr(g, name)),
                  f"compiled {tag}: buffer {i} {name} graph != eager")
        v = w.valid
        check(torch.equal(w.mac_bytes[v], g.mac_bytes[v]),
              f"compiled {tag}: buffer {i} bytes graph != eager")
        all_bytes &= torch.equal(w.mac_bytes, g.mac_bytes)
        for name in ("diag", "cfo"):
            worst[name] = max(worst[name], max_diff(getattr(w, name)[v],
                                                    getattr(g, name)[v]))
    se, sg = rxe.state, rxg.state
    for name in ("next_min_pos", "frames_seen", "carry_valid"):
        check(torch.equal(getattr(se, name), getattr(sg, name)),
              f"compiled {tag}: state {name} graph != eager")
    worst["carry"] = max_diff(se.carry, sg.carry)
    found = int(sg.frames_seen.sum())
    say("compiled", f"{tag}: {len(blocks)} buffers, graph = eager: "
        f"positions, valid, num_found, the valid slots' bytes (all slots' "
        f"bytes equal: {all_bytes}), next_min_pos, frames_seen exact "
        f"({found} frames); max abs diff diag {worst['diag']:.3g}, cfo "
        f"{worst['cfo']:.3g}, carry {worst['carry']:.3g}")
    S_ = len(blocks)
    fns = {m: (lambda i, r=r: r.feed(blocks[i % S_]))
           for m, r in (("eager", rxe), ("graph", rxg))}
    times, events = compiled_timing(tag, fns)
    replay, seen = check_replay_counts(tag, lambda: rxe.feed(blocks[0]),
                                       lambda: rxg.feed(blocks[0]), events, 4)
    say("compiled", f"{tag}: launches per replay = per eager call "
        f"{count_names(replay)}; profiler per replay {seen}")
    return {"tag": tag, "times": times, "launches": count_names(replay),
            "worst": worst, "capture_s": recs[0].capture_s,
            "pool_mib": recs[0].pool_bytes / 2**20}


def rx_app_cell(dev, card):
    """The rx CLI stream of phase 23 (a tx-written file of 20 stock
    buffers, 738 frames): the full drain, --drain metadata and --chunk 4,
    each run with its captured steps and eagerly, in turns.  The wall per
    buffer is the app's steady one (the buffers after the first call or
    chunk); the device time per buffer is taken over the same buffers: a
    profiled run of the file less a profiled run of its first call's
    buffers alone, which carries the same first-call work (the graphs'
    warm-up runs and capture, the first buffer or chunk)."""
    from pathlib import Path
    from c_ofdm_tpu_torch import ModemConfig
    from c_ofdm_tpu_torch.apps import txstream
    from c_ofdm_tpu_torch.ops import extract
    cfg = ModemConfig()
    buf = cfg.rx_buf_size * cfg.frame_len
    k2 = extract.extract_windows_single
    build = Path(__file__).resolve().parent / "c_ofdm_tpu_torch" / "_build"
    build.mkdir(exist_ok=True)
    cells = []
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        d = Path(tmp)
        n_long = 738
        payload = np.random.default_rng(SEED + 23).integers(
            0, 256, n_long * 248, dtype=np.uint8).tobytes()
        (d / "long.bin").write_bytes(payload)
        with eager_calls():
            rc, _ = _app(txstream, ["--in", d / "long.bin", "--out",
                                    d / "s.bin", "--gap", 500,
                                    "--device", dev])
        check(rc == 0, f"compiled rx: tx exited {rc}")
        stream = (d / "s.bin").read_bytes()
        for excl in (1, 4):         # int16 IQ: 4 bytes per sample
            (d / f"head{excl}.bin").write_bytes(stream[:excl * buf * 4])
        for label, extra in (("full", ()),
                             ("metadata", ("--drain", "metadata")),
                             ("chunk4", ("--drain", "metadata", "--chunk",
                                         4))):
            runs = {"eager": [], "graph": []}
            turns = ("eager", "graph", "graph", "eager") if label == "full" \
                else ("eager", "graph")
            for mode in turns:
                ctx = eager_calls() if mode == "eager" else \
                    contextlib.nullcontext()
                with ctx:
                    k0 = k2.launches
                    r = _rx_app(d, f"{label}_{mode}", d / "s.bin", dev,
                                *extra)
                    torch.cuda.synchronize()
                    runs[mode].append((r, k2.launches - k0))
            (be, re_, se), ke = runs["eager"][0]
            (bg, rg, sg), kg = runs["graph"][0]
            keys = ("buffers", "frames", "crc_failures", "max_seq",
                    "payload_checksum_u32")
            check(be == bg and {k: se.get(k) for k in keys}
                  == {k: sg.get(k) for k in keys},
                  f"compiled rx {label}: graph {sg} != eager {se}")
            same_rows(rg, re_, f"compiled rx {label}, graph against eager")
            cfo_diff = max((abs(a["cfo"] - b["cfo"]) for a, b in
                            zip(rg, re_)), default=0.0)
            check(sg["frames"] == n_long and sg["crc_failures"] == 0
                  and (label != "full" or bg == payload),
                  f"compiled rx {label}: {sg['frames']} frames")
            check(ke == kg == 2 * sg["buffers"],
                  f"compiled rx {label}: K2 launched {ke} (eager) and {kg} "
                  f"(graph) times in {sg['buffers']} buffers")
            per_buf = {m: statistics.median(
                buf / x[0][2]["steady_samples_per_s"] * 1e3
                for x in runs[m]) for m in runs}
            excl = 4 if label == "chunk4" else 1
            devt = {}
            for mode in ("eager", "graph"):
                ctx = eager_calls() if mode == "eager" else \
                    contextlib.nullcontext()
                run_ms = {}
                with ctx:
                    for part, src in (("all", d / "s.bin"),
                                      ("head", d / f"head{excl}.bin")):
                        run_ms[part], _ = device_ms(lambda i: _rx_app(
                            d, f"{label}_{mode}_prof_{part}", src, dev,
                            *extra), 1)
                devt[mode] = (run_ms["all"] - run_ms["head"]) / (
                    sg["buffers"] - excl)
            say("compiled", f"rx {label} on {card}: graph = eager (decoded "
                f"bytes, {len(rg)} metrics rows with cfo max abs diff "
                f"{cfo_diff:.3g}, tallies {({k: sg.get(k) for k in keys})}); "
                f"K2 {kg // sg['buffers']} per buffer in both; steady wall per "
                f"buffer (buffers after the first call or chunk) eager "
                f"{per_buf['eager']:.4f} ms (device over the same buffers, "
                f"a run less a run of its first {excl} buffer(s), "
                f"{devt['eager']:.4f} ms, idle "
                f"{1 - devt['eager'] / per_buf['eager']:.1%}), graph "
                f"{per_buf['graph']:.4f} ms (device {devt['graph']:.4f} ms, "
                f"idle {1 - devt['graph'] / per_buf['graph']:.1%}); "
                f"steady_samples_per_s eager "
                f"{[x[0][2]['steady_samples_per_s'] for x in runs['eager']]}"
                f", graph "
                f"{[x[0][2]['steady_samples_per_s'] for x in runs['graph']]}")
            cells.append({"tag": f"rx {label}", "times": {
                m: (per_buf[m], devt[m]) for m in runs}})
    return cells


def run_compiled(dev, card, stream_data):
    """Phase 25: the compiled paths on the card, each graph against the same
    code run eagerly; the launch counts of K1-K4 set to 0 at the start and
    read at the end (eager runs excluded)."""
    from c_ofdm_tpu_torch import ModemConfig, make_frame_spec
    from c_ofdm_tpu_torch.ops import dft, extract
    t0 = time.perf_counter()
    fns = (extract.extract_windows, extract.extract_windows_single,
           extract.extract_windows_multi, dft.dft)
    for f in fns:
        f.launches = 0
    dft.dft.radix_launches = dft.dft.dense_launches = 0
    rng = np.random.default_rng(SEED + 25)
    cells = []

    def timed(make):
        t = time.perf_counter()
        made = make()
        for c in (made if isinstance(made, list) else [made]):
            c["phase_s"] = time.perf_counter() - t
            cells.append(c)

    for tag, cfg, backend, batch in (
            ("flagship matmul", ModemConfig(), "matmul", B),
            ("flagship pallas", ModemConfig(), "pallas", B),
            ("wideband ct", ModemConfig(**WIDEBAND), "ct", B_WIDE)):
        timed(lambda: flagship_cell(dev, tag, cfg, backend, batch, rng,
                                    jit_check=backend == "matmul"))
    cfg = ModemConfig()
    for backend, chans in (("matmul", CHANNELS), ("pallas", (STATE_C,))):
        spec = make_frame_spec(cfg, torch.complex64, device=dev,
                               fft_backend=backend)
        for C in chans:
            timed(lambda: stream_cell(dev, f"stream {backend} C={C}", spec,
                                      stream_data[C][0], C))
    timed(lambda: rx_app_cell(dev, card))
    counts = {f.__name__: f.launches for f in fns}
    check(all(counts.values()), f"compiled: a kernel never replayed: {counts}")
    say("compiled", f"replay launches in this phase {counts} (K4 radix "
        f"{dft.dft.radix_launches}, dense {dft.dft.dense_launches})")
    print(json.dumps({"compiled": cells}), flush=True)
    say("compiled", f"phase took {time.perf_counter() - t0:.1f} s")
    return counts


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="FILE",
                    help="also write torch.profiler tables of 10 flagship "
                         "steps (FILE), 10 streaming buffers "
                         "(FILE.stream_c<C>) and 10 pallas and wideband "
                         "steps (FILE.pallas, FILE.wideband)")
    args = ap.parse_args()

    t_start = time.perf_counter()
    dev, card = phase_device()

    from c_ofdm_tpu_torch import ModemConfig, make_frame_spec
    from c_ofdm_tpu_torch.models import tx
    from c_ofdm_tpu_torch.models.modem import FlagshipStep
    from c_ofdm_tpu_torch.ops import extract

    phase_build()
    max_err = run_kernel_checks(dev)

    # ---- 4: main path, clean
    cfg = ModemConfig()
    step = FlagshipStep(make_frame_spec(cfg, torch.complex64, device=dev,
                                        fft_backend="matmul"))
    rng = np.random.default_rng(SEED)
    payload_np = rng.integers(0, 256, (B, cfg.frame_bytes), dtype=np.uint8)
    payload = torch.from_numpy(payload_np).to(dev)
    extract.extract_windows.launches = 0
    res, s = step(payload)
    torch.cuda.synchronize()
    launches = extract.extract_windows.launches
    check(launches == 1, f"K1 launched {launches} times in one step, not 1")
    check(torch.equal(res.mac_bytes, payload), "clean step: payload mismatch")
    check(bool(s.found.all()), "clean step: a frame was not found")
    check(not bool(s.frame_start.any()), "clean step: frame_start != 0")
    say("clean", f"B={B} frames of {cfg.frame_len} samples: all found, "
        f"frame_start 0, payloads exact, K1 launches {launches}")

    # ---- 5: main path, impaired, against the port's plain CPU run
    frames = tx.transmit(step.bound_spec(), payload).cpu().numpy()
    caps_np, offs = impaired_captures(frames.astype(np.complex128), rng)
    cpu_step = FlagshipStep(make_frame_spec(cfg, torch.complex64,
                                            device="cpu",
                                            fft_backend="matmul"))
    check_impaired("impaired", step, cpu_step, caps_np, offs, payload_np,
                   {extract.extract_windows: 1})
    say("impaired", f"B={B}+{ZERO_ROWS} captures of {caps_np.shape[1]} "
        f"samples, offsets {int(offs.min())}..{int(offs.max())}: all frames "
        f"found at their planted offsets, payloads exact, zero rows not "
        f"found, sync and bytes equal to the CPU run")

    # ---- 6: timing
    _, _, events = time_step("timing", step, payload, B * cfg.frame_len)
    if args.profile:
        write_profile(args.profile, events, "10 steps")

    win = cfg.preamble_len + cfg.message_len
    # 8 input sets (~98 MB) so each launch finds its input outside the
    # 50 MB L2, as after a fresh capture
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    xs = [torch.randn(B, cfg.frame_len, dtype=torch.complex64, device=dev,
                      generator=g) for _ in range(8)]
    sts = [torch.randint(0, cfg.frame_len - win + 1, (B,), device=dev,
                         dtype=torch.int32, generator=g) for _ in range(8)]
    libs = [library_gather(x, st, win) for x, st in zip(xs, sts)]
    fns = {"kernel": lambda i: extract.extract_windows(xs[i % 8], sts[i % 8], win),
           "plain": lambda i: extract.extract_windows_ref(xs[i % 8], sts[i % 8], win),
           "library": lambda i: libs[i % 8](i)}
    for fn in fns.values():
        cuda_ms(fn, 16)
    wall = {k: [] for k in fns}
    devt = {k: [] for k in fns}
    for order in (tuple(fns), tuple(reversed(fns))) * 3:
        for k in order:
            wall[k].append(cuda_ms(fns[k], 200))
            devt[k].append(device_ms(fns[k], 64)[0])
    k_ms, p_ms, l_ms = (statistics.median(devt[k]) for k in fns)
    moved = 2 * B * win * 8
    k1_bound = bytes_ms(moved + B * 4)
    for k, ms in (("kernel", k_ms), ("plain", p_ms), ("library", l_ms)):
        w = statistics.median(wall[k])
        label = {"kernel": "kernel", "plain": "plain gather",
                 "library": "library (unfold + index)"}[k]
        say("timing", f"K1 [{B},{cfg.frame_len}]->[{B},{win}] c64, {label}: "
            f"device {ms * 1e3:.3f} us ({moved / (ms * 1e-3) / 1e9:.1f} GB/s "
            f"effective, {moved / (ms * 1e-3) / 3.35e12:.1%} of 3.35 TB/s); "
            f"{w * 1e3:.2f} us per call with host dispatch; bound "
            f"{k1_bound * 1e3:.3f} us (bytes)")

    # ---- 7-13: the streaming receiver
    ring_err = run_ring_kernel_checks(dev)
    stream = run_streaming(dev, args.profile)

    # ---- 14-18: K4, the pallas step, the other backends, wideband
    dft_err = run_dft_checks(dev)
    k4_launches, _, _ = run_pallas_step(dev, payload_np, caps_np, offs,
                                        args.profile)
    run_backends(dev, payload_np)
    run_wideband(dev, args.profile)
    k4 = dft_timing(dev)
    t19 = time.perf_counter()
    gather_timing(dev)
    say("gather-timing", f"phase took {time.perf_counter() - t19:.1f} s")

    # ---- 20-22: the MAC-framed link loop
    run_mac(dev)
    run_link_batch(dev)
    run_link_stream(dev)

    # ---- 23: the CLI apps
    run_apps(dev, card)

    # ---- 24: parallel/
    k3_sharded = run_parallel(dev, card)

    # ---- 25: the compiled paths (CUDA-graph replays)
    replays = run_compiled(dev, card, stream["data"])
    say("compiled", f"all phases {time.perf_counter() - t_start:.1f} s")

    src = "c_ofdm_tpu_torch/csrc/extract_windows.cu"
    print(json.dumps({"kernels": [{
        "name": "extract_windows",
        "route": "cuda",
        "source": src,
        "replaces": "c_ofdm_tpu/ops/pallas_extract.py:37",
        "launches": launches + replays["extract_windows"],
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": k1_bound,
        "bound_by": "bytes",
        "library_ms": l_ms,
    }, {
        "name": "extract_windows_single",
        "route": "cuda",
        "source": src,
        "replaces": "c_ofdm_tpu/ops/pallas_extract.py:108",
        "launches": (stream["launches"]["single"]
                     + replays["extract_windows_single"]),
        "max_abs_err": ring_err["single"],
        "ms": stream["kernel_ms"]["single"],
        "plain_ms": stream["plain_ms"]["single"],
        "bound_ms": stream["bound_ms"]["single"],
        "bound_by": "bytes",
        "library_ms": stream["library_ms"]["single"],
    }, {
        "name": "extract_windows_multi",
        "route": "cuda",
        "source": src,
        "replaces": "c_ofdm_tpu/ops/pallas_extract.py:183",
        "launches": (stream["launches"]["multi"] + k3_sharded
                     + replays["extract_windows_multi"]),
        "max_abs_err": ring_err["multi"],
        "ms": stream["kernel_ms"]["multi"],
        "plain_ms": stream["plain_ms"]["multi"],
        "bound_ms": stream["bound_ms"]["multi"],
        "bound_by": "bytes",
        "library_ms": stream["library_ms"]["multi"],
    }, {
        "name": "dft",
        "route": "cuda",
        "source": "c_ofdm_tpu_torch/csrc/dft.cu",
        "replaces": "c_ofdm_tpu/ops/pallas_fft.py:41",
        "launches": k4_launches + replays["dft"],
        "max_abs_err": dft_err,
        "ms": k4["cold"]["kernel"],
        "plain_ms": k4["cold"]["plain"],
        "bound_ms": k4["bound"],
        "bound_by": k4["bound_by"],
        "library_ms": k4["cold"]["library"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
