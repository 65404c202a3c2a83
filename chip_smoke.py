"""Quickest proof that the PyTorch port (c_ofdm_tpu_torch) runs on a GPU.

    python3 chip_smoke.py [--profile FILE]

Needs one CUDA device and nvcc (on PATH or under $CUDA_HOME/bin).  Drives
two paths of the port, stock ModemConfig, complex64, matmul backend:
the flagship step (payload -> transmit -> receive_batch, B = 256 frames,
``FlagshipStep``) and the streaming receiver (``StreamingReceiver``, gated
sync on the 41-frame ring of 246 656 samples, S = 4 consecutive buffers at
C = 1, 8 and 64 channels).  Phases, each printing its lines:

  1 device    the card, its name and power limit (nvidia-smi)
  2 build     csrc/extract_windows.cu (K1, K2, K3) built by nvcc for sm_90a
  3 kernel    K1 against its plain PyTorch version, bit for bit
  4 clean     B = 256 payloads decode exactly, one K1 launch per step
  5 impaired  B = 256 frames at random offsets with CFO and 30 dB AWGN plus
              4 all-zero rows: exact payloads and positions, and the same
              result as the port's plain CPU run
  6 timing    the step (CUDA events) and its device time and idle share,
              K1 against the plain gather (device time, torch.profiler)
  7 ring      K2 and K3 against their plain versions, bit for bit, at the
              streaming shapes, complex128, negative and past-end starts
  8 stream    rings built as bench.py builds them (fill 0.8, random gaps,
              CFO 1e-4, amplitude 60, 26 dB AWGN), C = 1/8/64: every planted
              frame decodes exactly once, in order, at its planted start,
              with exact bytes; K2 (C = 1) or K3 (C > 1) launched twice per
              buffer, K1 never
  9 stream-cpu  C = 1 and 8: every output field equal to the port's CPU run
 10 state     save_state/load_state after buffer 2 resumes identically
 11 no-sync   one C = 8 buffer under torch.cuda.set_sync_debug_mode("error")
 12 stream-timing  per-buffer median (CUDA events), samples/s, device time
              and idle share at C = 1/8/64; K2/K3 against their plain
              versions at the path's shapes (device time, torch.profiler)

Then one JSON line describing the kernels, and last one JSON line
``{"ok": true, "device": {...}}``.  Any failed phase raises: the script
exits non-zero and prints no result.  ``--profile FILE`` also writes a
torch.profiler table of 10 flagship steps to FILE and one of 10 streaming
buffers at each C to FILE.stream_c<C>.
"""

import argparse
import io
import itertools
import json
import statistics
import subprocess
import time

import numpy as np
import torch

B = 256            # frames per step (bench.py's flagship batch)
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
    return dev


def phase_build():
    from c_ofdm_tpu_torch.ops import _kernels, extract
    t0 = time.perf_counter()
    extract._lib()
    secs = time.perf_counter() - t0
    log = _kernels.library_path("extract_windows").with_suffix(".log")
    ptxas = ([ln.strip() for ln in log.read_text().splitlines()
              if "registers" in ln or "spill" in ln] if log.exists() else [])
    say("build", f"K1-K3 built/loaded in {secs:.2f} s "
        f"({_kernels.library_path('extract_windows').name})")
    for ln in ptxas:
        say("build", f"ptxas: {ln}")


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


def streaming_buffers(spec, C, seed):
    """S consecutive ingest buffers per channel, made on the spec's device
    as bench.py::_make_rings_cpu makes them: int(0.8 * S * buf / frame_len)
    frames of random frame_bytes payloads (``transmit``) per channel at
    multinomial random gaps, CFO 1e-4 cycles/sample, amplitude 60, AWGN at
    26 dB SNR.  Returns (blocks [S, C, buf] complex64, or [S, buf] at
    C = 1; per channel the planted (start, payload) of each frame that
    fits in the S buffers)."""
    from c_ofdm_tpu_torch.models import tx
    cfg = spec.cfg
    dev = spec.device
    buf = cfg.rx_buf_size * cfg.frame_len
    total = S * buf
    rng = np.random.default_rng(seed)
    nf = int(0.8 * total / cfg.frame_len)
    payload = rng.integers(0, 256, (C, nf, cfg.frame_bytes), dtype=np.uint8)
    gaps = np.stack([rng.multinomial(total - nf * cfg.frame_len,
                                     np.ones(nf + 1) / (nf + 1))
                     for _ in range(C)])
    starts = np.cumsum(gaps[:, :nf], axis=1) + cfg.frame_len * np.arange(nf)
    frames = tx.transmit(spec, torch.from_numpy(payload).to(dev))
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
    truth = [[(int(s), payload[c, i]) for i, s in enumerate(starts[c])
              if s + cfg.frame_len < total] for c in range(C)]
    return (blocks[:, 0].contiguous() if C == 1 else blocks), truth


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
    spec = make_frame_spec(cfg, torch.complex64, device=dev)
    buf = cfg.rx_buf_size * cfg.frame_len
    data = {C: streaming_buffers(spec, C, SEED + 10 + C) for C in CHANNELS}
    torch.cuda.synchronize()
    kernels = {"single": extract.extract_windows_single,
               "multi": extract.extract_windows_multi}

    # ---- 8: the main streaming path, counts from 0
    for fn in (extract.extract_windows, *kernels.values()):
        fn.launches = 0
    outs = {}
    for C in CHANNELS:
        rxr = streaming.StreamingReceiver(spec, channels=0 if C == 1 else C)
        per_buf = []
        outs[C] = []
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
        n_frames = check_truth(spec, outs[C], data[C][1], C)
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
    cpu_spec = make_frame_spec(cfg, torch.complex64, device="cpu")
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

    # ---- 11: no host synchronisation inside one gated buffer
    rxr = streaming.StreamingReceiver(spec, channels=C)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = rxr.feed(blocks[0])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    same_outputs([out], outs[C][:1], f"C={C} under sync debug mode")
    say("no-sync", f"C={C}: one gated buffer ran under "
        f"set_sync_debug_mode('error') with no host synchronisation")

    # ---- 12: timing
    kernel_ms, plain_ms = stream_timing(spec, data, profile)
    return {"launches": launches, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms}


def stream_timing(spec, data, profile=None):
    """Phase 12: per-buffer time at C = 1/8/64, then K2/K3 against their
    plain versions.  Returns the device ms per buffer of the two K2
    launches at C = 1 and of the two K3 launches at C = 8, kernel and
    plain."""
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
                       extract.extract_windows_single_ref(x, s, w)}
            else:
                fns = {"kernel": lambda i, x=rings, s=st, w=win:
                       extract.extract_windows_multi(x, s, w),
                       "plain": lambda i, x=rings, s=st, w=win:
                       extract.extract_windows_multi_ref(x, s, w)}
            for fn in fns.values():
                cuda_ms(fn, 16)
            wall = {key: [] for key in fns}
            devt = {key: [] for key in fns}
            for order in (("plain", "kernel"), ("kernel", "plain")) * 2:
                for key in order:
                    wall[key].append(cuda_ms(fns[key], 100))
                    devt[key].append(device_ms(fns[key], 32)[0])
            moved = 2 * C * k * win * 8
            for key in ("kernel", "plain"):
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
            f"plain {totals[(C, 'plain')]:.5f} ms (device)")
    return ({"single": totals[(1, "kernel")], "multi": totals[(8, "kernel")]},
            {"single": totals[(1, "plain")], "multi": totals[(8, "plain")]})


def impaired_captures(frames, rng):
    """frames [B, frame_len] complex -> captures [B + ZERO_ROWS,
    frame_len + EXTRA] complex64 (numpy) and the planted offsets: each
    frame at a random offset, amplitude 40, CFO 1e-4 cycles/sample, AWGN
    at 30 dB SNR (as __graft_entry__.py builds its impaired streams), then
    ZERO_ROWS all-zero rows."""
    nb, flen = frames.shape
    n = flen + EXTRA
    offs = rng.integers(0, EXTRA + 1, nb)
    caps = np.zeros((nb + ZERO_ROWS, n), np.complex128)
    for b in range(nb):
        caps[b, offs[b]:offs[b] + flen] = frames[b] * 40.0
    caps[:nb] *= np.exp(2j * np.pi * 1e-4 * np.arange(n))
    std = np.sqrt(float((np.abs(frames) ** 2).mean()) * 40.0 ** 2
                  * 10 ** (-30.0 / 10) / 2)
    caps[:nb] += std * (rng.standard_normal((nb, n))
                        + 1j * rng.standard_normal((nb, n)))
    return caps.astype(np.complex64), offs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="FILE",
                    help="also write torch.profiler tables of 10 flagship "
                         "steps (FILE) and 10 streaming buffers "
                         "(FILE.stream_c<C>)")
    args = ap.parse_args()

    dev = phase_device()

    from c_ofdm_tpu_torch import ModemConfig, make_frame_spec
    from c_ofdm_tpu_torch.models import tx
    from c_ofdm_tpu_torch.models.modem import FlagshipStep
    from c_ofdm_tpu_torch.ops import extract

    phase_build()
    max_err = run_kernel_checks(dev)

    # ---- 4: main path, clean
    cfg = ModemConfig()
    step = FlagshipStep(make_frame_spec(cfg, torch.complex64, device=dev))
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
    caps = torch.from_numpy(caps_np).to(dev)
    extract.extract_windows.launches = 0
    res, s = step.receive(caps)
    torch.cuda.synchronize()
    check(extract.extract_windows.launches == 1,
          "impaired batch: K1 not launched exactly once")
    found = s.found.cpu().numpy()
    fs = s.frame_start.cpu().numpy()
    got = res.mac_bytes.cpu().numpy()
    check(found[:B].all(), f"impaired: {int((~found[:B]).sum())} frames lost")
    check(not found[B:].any(), "impaired: a frame found in an all-zero row")
    check(np.array_equal(fs[:B], offs),
          f"impaired: frame_start != planted offset on "
          f"{int((fs[:B] != offs).sum())} rows")
    check(np.array_equal(got[:B], payload_np), "impaired: payload mismatch")
    cpu_step = FlagshipStep(make_frame_spec(cfg, torch.complex64, device="cpu"))
    res_c, s_c = cpu_step.receive(torch.from_numpy(caps_np))
    for name in ("frame_start", "t2_begin", "pr_begin", "found"):
        check(np.array_equal(getattr(s, name).cpu().numpy(),
                             getattr(s_c, name).numpy()),
              f"impaired: {name} differs from the CPU run")
    check(np.array_equal(got[found], res_c.mac_bytes.numpy()[found]),
          "impaired: mac_bytes differ from the CPU run")
    say("impaired", f"B={B}+{ZERO_ROWS} captures of {caps_np.shape[1]} "
        f"samples, offsets {int(offs.min())}..{int(offs.max())}: all frames "
        f"found at their planted offsets, payloads exact, zero rows not "
        f"found, sync and bytes equal to the CPU run")

    # ---- 6: timing
    for _ in range(5):
        step(payload)
    torch.cuda.synchronize()
    step_ms = [cuda_ms(lambda i: step(payload), 1) for _ in range(30)]
    med = statistics.median(step_ms)
    say("timing", f"step (TX+RX, B={B}): median {med:.4f} ms over "
        f"{len(step_ms)} runs (min {min(step_ms):.4f}, max "
        f"{max(step_ms):.4f}), {B * cfg.frame_len / (med * 1e-3):.4g} "
        f"samples/s")
    dev_ms, events = device_ms(lambda i: step(payload), 10)
    say("timing", f"step device time {dev_ms:.4f} ms (kernel sum, "
        f"torch.profiler over 10 steps): device idle {1 - dev_ms / med:.1%} "
        f"of the step")
    if args.profile:
        with open(args.profile, "w") as f:
            f.write(events.table(sort_by="self_cuda_time_total", row_limit=80))
        say("profile", f"10 steps -> {args.profile}")

    win = cfg.preamble_len + cfg.message_len
    # 8 input sets (~98 MB) so each launch finds its input outside the
    # 50 MB L2, as after a fresh capture
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    xs = [torch.randn(B, cfg.frame_len, dtype=torch.complex64, device=dev,
                      generator=g) for _ in range(8)]
    sts = [torch.randint(0, cfg.frame_len - win + 1, (B,), device=dev,
                         dtype=torch.int32, generator=g) for _ in range(8)]
    fns = {"kernel": lambda i: extract.extract_windows(xs[i % 8], sts[i % 8], win),
           "plain": lambda i: extract.extract_windows_ref(xs[i % 8], sts[i % 8], win)}
    for fn in fns.values():
        cuda_ms(fn, 16)
    wall = {k: [] for k in fns}
    devt = {k: [] for k in fns}
    for order in (("plain", "kernel"), ("kernel", "plain")) * 3:
        for k in order:
            wall[k].append(cuda_ms(fns[k], 200))
            devt[k].append(device_ms(fns[k], 64)[0])
    k_ms, p_ms = (statistics.median(devt[k]) for k in ("kernel", "plain"))
    moved = 2 * B * win * 8
    for k, ms in (("kernel", k_ms), ("plain gather", p_ms)):
        w = statistics.median(wall["kernel" if k == "kernel" else "plain"])
        say("timing", f"K1 [{B},{cfg.frame_len}]->[{B},{win}] c64, {k}: "
            f"device {ms * 1e3:.3f} us ({moved / (ms * 1e-3) / 1e9:.1f} GB/s "
            f"effective, {moved / (ms * 1e-3) / 3.35e12:.1%} of 3.35 TB/s); "
            f"{w * 1e3:.2f} us per call with host dispatch")

    # ---- 7-12: the streaming receiver
    ring_err = run_ring_kernel_checks(dev)
    stream = run_streaming(dev, args.profile)
    src = "c_ofdm_tpu_torch/csrc/extract_windows.cu"
    print(json.dumps({"kernels": [{
        "name": "extract_windows",
        "route": "cuda",
        "source": src,
        "replaces": "c_ofdm_tpu/ops/pallas_extract.py:37",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }, {
        "name": "extract_windows_single",
        "route": "cuda",
        "source": src,
        "replaces": "c_ofdm_tpu/ops/pallas_extract.py:108",
        "launches": stream["launches"]["single"],
        "max_abs_err": ring_err["single"],
        "ms": stream["kernel_ms"]["single"],
        "plain_ms": stream["plain_ms"]["single"],
    }, {
        "name": "extract_windows_multi",
        "route": "cuda",
        "source": src,
        "replaces": "c_ofdm_tpu/ops/pallas_extract.py:183",
        "launches": stream["launches"]["multi"],
        "max_abs_err": ring_err["multi"],
        "ms": stream["kernel_ms"]["multi"],
        "plain_ms": stream["plain_ms"]["multi"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
