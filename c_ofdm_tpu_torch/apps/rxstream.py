"""Streaming receiver app — the reference ``rx`` binary's role
(`rx.cpp:94-237`): continuous ingest -> streaming sync/demod -> payload sink,
with per-buffer stage tracing flushed once at exit (LOG.txt pattern).

Usage:
  python -m c_ofdm_tpu_torch.apps.rxstream --in capture.bin --format i16 \
      --out decoded.bin [--log LOG.txt] [--metrics metrics.jsonl] \
      [--summary-json summary.json] [--device cuda]

Input formats: i16 (interleaved int16 IQ, scaled by config mult) or
f64 (interleaved float64 IQ, reference data.bin layout).

The loop is pipelined like the reference's double-buffer thread
(`rx.cpp:55-66`), but against the card instead of the radio: while the card
demodulates buffer N, the host reads buffer N+1 from the source and stages
it (a pinned host slot, copied on a side stream), and buffer N-1's results
are read back (their copy was enqueued before buffer N's kernels, so waiting
for it does not wait for N — CUDA launches are asynchronous).  The
end-of-run summary reports host-feed vs device-wait time so feed-bound
operation is visible, like ``st_rx``'s ingest benchmark.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

from ..io import trace as tracing
from . import add_device_arg, resolve_device


class BlockStager:
    """Host blocks -> device tensors, the rx.cpp:55-66 double-buffer role.

    int16 blocks [n, 2] go up as they are (``process_buffer`` converts and
    scales them on the device); complex blocks go up as interleaved float32
    [n, 2].  On a CUDA device each block is written into one of ``SLOTS``
    pinned host tensors and copied with ``non_blocking=True`` on a side copy
    stream; the compute stream waits on the copy's event.  A slot is
    refilled only after its previous copy's event has completed: the host
    must not overwrite a buffer the card is still reading.  Two slots let
    the host fill one while the other's copy is in flight."""

    SLOTS = 2

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self._host = [None] * self.SLOTS
        self._events = [None] * self.SLOTS
        self._next = 0
        self._copy_stream = torch.cuda.Stream(device) if self.cuda else None

    @staticmethod
    def _wire(block: np.ndarray) -> np.ndarray:
        if np.iscomplexobj(block):
            return np.stack([block.real, block.imag],
                            axis=-1).astype(np.float32)
        return block.astype(np.int16, copy=False)

    def __call__(self, block: np.ndarray) -> torch.Tensor:
        if not self.cuda:
            return torch.from_numpy(np.array(self._wire(block)))
        k = self._next
        self._next = (k + 1) % self.SLOTS
        rec = tracing.recorder
        if rec.on:
            with rec.span("slot_wait"):
                self._wait(k)
            with rec.span("fill"):
                host = self._fill(k, block)
            with rec.span("h2d"):
                return self._h2d(k, host)
        self._wait(k)
        return self._h2d(k, self._fill(k, block))

    def _wait(self, k: int) -> None:
        if self._events[k] is not None:
            self._events[k].synchronize()      # its last copy has left

    def _fill(self, k: int, block: np.ndarray) -> torch.Tensor:
        """Slot ``k``'s pinned host tensor, holding ``block``."""
        dtype = torch.float32 if np.iscomplexobj(block) else torch.int16
        host = self._host[k]
        if host is None or host.shape[0] != block.shape[0] \
                or host.dtype != dtype:
            host = torch.empty((block.shape[0], 2), dtype=dtype,
                               pin_memory=True)
            self._host[k] = host
        h = host.numpy()
        if np.iscomplexobj(block):
            h[:, 0] = block.real
            h[:, 1] = block.imag
        else:
            h[...] = block
        return host

    def _h2d(self, k: int, host: torch.Tensor) -> torch.Tensor:
        """Enqueue slot ``k``'s copy on the side stream; the compute stream
        waits for it."""
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            dev = host.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        compute.wait_event(done)
        # the block was allocated on the copy stream and is read on the
        # compute stream: keep its memory until that stream is done with it
        dev.record_stream(compute)
        self._events[k] = done
        return dev


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--in", dest="inp", required=True,
                   help="capture file or '-' for stdin")
    p.add_argument("--format", choices=("i16", "f64"), default="i16")
    p.add_argument("--out", default="decoded.bin")
    p.add_argument("--config", default="")
    p.add_argument("--log", default="", help="stage-trace LOG.txt path")
    p.add_argument("--metrics", default="", help="per-frame metrics jsonl")
    p.add_argument("--native-ingest", action="store_true",
                   help="use the C++ ingest ring for file reads (i16 only; NB the replay source loops the file like the reference's cyclic TX)")
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--sync-mode", choices=("gated", "dense"), default="gated",
                   help="gated (default): two-tone-gated matched filter, the "
                        "production path, multi-channel capable.  dense: "
                        "matched-filter every ring lag — detector-independent "
                        "parity fallback, single-channel only (the "
                        "library's process_buffer raises on channel-batched "
                        "state in dense mode) and much slower")
    p.add_argument("--summary-json", default="",
                   help="write end-of-run throughput summary JSON here "
                        "('-' = stdout)")
    p.add_argument("--drain", choices=("full", "metadata"), default="full",
                   help="'full' reads payloads back to --out per buffer; "
                        "'metadata' keeps payloads on the device and "
                        "accumulates CRC/seq tallies there, reading back 32 "
                        "bytes at the end — the ingest+compute rate without "
                        "the per-buffer readback and host-side sink")
    p.add_argument("--chunk", type=int, default=1,
                   help="metadata mode: buffers run back to back per "
                        "dispatch group, with no host sync between them "
                        "(a short tail group is zero-padded).  The card's "
                        "launches are asynchronous already, so chunk 1 is "
                        "fine; kept for parity with the JAX app")
    p.add_argument("--profile", default="",
                   help="write a torch.profiler chrome trace of the run "
                        "into this directory (view in chrome://tracing or "
                        "Perfetto), with the program's spans on its clock; "
                        "turns the trace recorder on (io/trace.py)")
    add_device_arg(p)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    from c_ofdm_tpu_torch import ModemConfig, load_config, make_frame_spec
    from c_ofdm_tpu_torch.io.trace import StageTrace
    from c_ofdm_tpu_torch.mac.mac import Mac
    from c_ofdm_tpu_torch.models import streaming
    from c_ofdm_tpu_torch.utils import graphs

    cfg = load_config(args.config) if args.config else ModemConfig()
    spec = make_frame_spec(cfg, torch.complex64, device=dev,
                           fft_backend="matmul")
    mac = Mac(frame_bytes=cfg.frame_bytes, spread=cfg.mod_type)
    rxr = streaming.StreamingReceiver(spec, max_frames=args.max_frames,
                                      sync_mode=args.sync_mode)
    trace = StageTrace()
    cuda = dev.type == "cuda"

    buf_samples = cfg.rx_buf_size * cfg.frame_len

    def buffers():
        if args.native_ingest and args.format == "i16" and args.inp != "-":
            from c_ofdm_tpu_torch.io.ingest import NativeIngest, SRC_FILE_REPLAY
            # file replay loops forever; stop after covering the file once
            n_bufs = max(1, os.path.getsize(args.inp) // (buf_samples * 4) + 1)
            with NativeIngest(SRC_FILE_REPLAY, args.inp, buf_samples, 4) as ing:
                for _ in range(n_bufs):
                    buf = ing.pop_complex64()
                    if buf is None:
                        break
                    yield buf / cfg.mult
            return
        src = sys.stdin.buffer if args.inp == "-" else open(args.inp, "rb")
        itemsize = 4 if args.format == "i16" else 16
        try:
            while True:
                raw = src.read(buf_samples * itemsize)
                if not raw:
                    break
                if args.format == "i16":
                    # keep the SDR wire format: int16 [n, 2] staged as-is
                    # and converted/scaled on the device (process_buffer):
                    # half the host->device bytes of a float32 stage
                    block = np.frombuffer(raw, dtype=np.int16).reshape(-1, 2)
                    if block.shape[0] < buf_samples:
                        block = np.pad(block, ((0, buf_samples
                                                - block.shape[0]), (0, 0)))
                else:
                    d = np.frombuffer(raw, dtype=np.float64)
                    block = (d[0::2] + 1j * d[1::2]).astype(np.complex64)
                    if block.size < buf_samples:
                        block = np.pad(block, (0, buf_samples - block.size))
                yield block
        finally:
            if args.inp != "-":
                src.close()

    out_f = open(args.out, "wb")
    n_frames = 0
    n_crc_bad = 0
    n_bufs = 0
    max_seq = None      # metadata drain only: max MAC seq seen (device max)
    payload_sum = None  # metadata drain only: uint32 payload checksum
    #                     (documented mod-2^32 wraparound on long runs)
    metrics_rows = []
    t_feed = 0.0       # host staging (pinned slot fill + copy enqueue)
    t_drain = 0.0      # blocked on device results

    # The JAX app's jitted steps (decode_out, tally, chunk_step) are
    # captured calls on the card (utils/graphs.py: one CUDA-graph replay
    # each, captured on first use) and eager on the CPU.
    decode_graph = graphs.CapturedCall("rx.decode_out")
    tally_graph = graphs.CapturedCall("rx.tally")
    chunk_graph = graphs.CapturedCall("rx.chunk_step")

    # MAC deframing happens ON THE DEVICE and only the deframed payload bytes
    # and the metadata come back: the soft metrics are 8x the payload size,
    # and every readback is a wait on the card.  Integer metadata is int64
    # (the MAC seq is int64 holding the uint32 value: no bitcast needed).
    def _decode_out(diag, valid, positions, cfo):
        frs = mac.read_soft(diag)
        meta = torch.stack([valid.to(torch.int64),
                            frs.valid.to(torch.int64),
                            frs.seq,
                            positions.to(torch.int64)], dim=-1)
        return frs.payload, meta, cfo.to(torch.float32)

    def decode_out(o):
        return decode_graph(_decode_out, (o.diag, o.valid, o.positions, o.cfo))

    def start_readback(i, out):
        """Enqueue buffer i's decode and its copy to pinned host memory;
        returns what ``materialize`` waits on."""
        res = decode_out(out)
        if not cuda:
            return i, res, None
        host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                     .copy_(t, non_blocking=True) for t in res)
        done = torch.cuda.Event()
        done.record()
        return i, host, done

    def materialize(i, host, done):
        """Wait for buffer i's results and sink them (runs one iteration
        behind the dispatch, overlapping buffer i+1's compute)."""
        nonlocal n_frames, n_crc_bad, t_drain
        t0 = time.perf_counter()
        if done is not None:
            done.synchronize()
        payloads, meta, cfo = (t.numpy() for t in host)
        t_drain += time.perf_counter() - t0
        valid = meta[:, 0] > 0
        for k in np.nonzero(valid)[0]:
            ok = bool(meta[k, 1] > 0)
            n_crc_bad += (not ok)
            out_f.write(payloads[k].tobytes())
            if args.metrics:
                metrics_rows.append({
                    "buf": i, "slot": int(k), "pos": int(meta[k, 3]),
                    "seq": int(meta[k, 2]), "cfo": float(cfo[k]),
                    "crc_ok": ok,
                })
            n_frames += 1
        trace.point("MAC")
        trace.value("DET", n_frames)
        trace.value("FR_IN_BUF", int(valid.sum()))

    # --drain metadata: everything stays on the device; per buffer the
    # StreamOut folds into four int64 tallies (frames, CRC failures, max
    # seq, payload checksum mod 2^32) updated in place in ``acc`` [4], read
    # back once at exit.
    acc = torch.zeros(4, dtype=torch.int64, device=dev)

    def _tally(diag, valid):
        frs = mac.read_soft(diag)
        bad = valid & ~frs.valid
        ok = valid & frs.valid
        psum = torch.where(ok[..., None], frs.payload, 0).to(
            torch.int64).sum()
        acc.copy_(torch.stack([
            acc[0] + valid.sum(),
            acc[1] + bad.sum(),
            torch.maximum(acc[2], torch.where(ok, frs.seq, 0).max()),
            (acc[3] + psum) & 0xFFFFFFFF]))

    def tally(o):
        tally_graph(_tally, (o.diag, o.valid), restore=(acc,))

    stage = BlockStager(dev)

    def staged_blocks():
        """Read the next host buffer and stage it on the device while the
        card is busy with the previous one (rx.cpp:55-66 double-buffer
        role)."""
        nonlocal t_feed
        for block in buffers():
            t0 = time.perf_counter()
            dev_block = stage(block)
            t_feed += time.perf_counter() - t0
            yield dev_block

    def read_acc():
        return [int(v) for v in acc.cpu()]   # 32 bytes

    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU]
                       + ([ProfilerActivity.CUDA] if cuda else []))
        tracing.enable()       # spans, stage marks in the graphs, counts
    else:
        prof = contextlib.nullcontext()
    t_wall0 = time.perf_counter()
    t_steady = None    # set after buffer 0 drains (first-call costs excluded)

    with prof:
        if args.drain == "metadata" and args.chunk > 1:
            bspec = rxr.bound_spec()
            # the stream state threaded through the chunk, updated in place
            state = streaming.init_state(bspec)
            pend = []
            first = True

            def _chunk_step(*blocks):
                """The JAX app's chunk_step (a lax.scan over the chunk):
                process_buffer + tally per buffer, the state carried in
                ``state``'s tensors."""
                for blk in blocks:
                    new, out = streaming.process_buffer(
                        bspec, state, blk, rxr.max_frames, args.sync_mode)
                    for t, v in zip(state, new):
                        t.copy_(v)
                    _tally(out.diag, out.valid)

            def flush():
                """Run one group of ``chunk`` buffers back to back (a short
                tail group zero-padded, as the JAX app's scan runs it)."""
                nonlocal t_steady, first, n_bufs
                blocks = pend + [torch.zeros_like(pend[0])] * (
                    args.chunk - len(pend))
                chunk_graph(_chunk_step, blocks, restore=(*state, acc))
                n_bufs += len(pend)
                pend.clear()
                if first:
                    int(acc[0])            # chunk 0 carries first-call costs
                    t_steady = time.perf_counter()
                    first = False

            for dev_block in staged_blocks():
                pend.append(dev_block)
                if len(pend) == args.chunk:
                    flush()
            if pend:
                flush()
            n_frames, n_crc_bad, max_seq, payload_sum = read_acc()
        elif args.drain == "metadata":
            for i, dev_block in enumerate(staged_blocks()):
                trace.iter_start(ITER=i)
                out = rxr.feed(dev_block)   # asynchronous launches
                tally(out)                  # stays on the device
                trace.point("RX_STEP")
                n_bufs += 1
                if i == 0:
                    int(acc[0])             # buffer 0 carries first-call costs
                    t_steady = time.perf_counter()
            n_frames, n_crc_bad, max_seq, payload_sum = read_acc()
        else:
            pending = None  # buffer whose results are still on the way
            for i, dev_block in enumerate(staged_blocks()):
                trace.iter_start(ITER=i)
                out = rxr.feed(dev_block)   # asynchronous launches
                nxt = start_readback(i, out)
                trace.point("RX_STEP")
                n_bufs += 1
                if pending is not None:
                    materialize(*pending)   # overlaps buffer i's compute
                    if t_steady is None:
                        t_steady = time.perf_counter()
                pending = nxt
            if pending is not None:
                materialize(*pending)
                if t_steady is None:
                    t_steady = time.perf_counter()
    wall = time.perf_counter() - t_wall0
    out_f.close()
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        path = os.path.join(args.profile, "rxstream_trace.json")
        prof.export_chrome_trace(path)
        recorded = tracing.drain()
        tracing.disable()
        tracing.merge_chrome_trace(path, recorded)
        with open(path) as f:
            stages = tracing.stage_split(json.load(f)["traceEvents"])

    # buffers processed before t_steady (first-call costs) are excluded from
    # the steady rate: one buffer normally, the whole first chunk when
    # chunking
    excl = args.chunk if (args.drain == "metadata" and args.chunk > 1) else 1
    steady_bufs = max(n_bufs - excl, 0)
    steady_wall = max(time.perf_counter() - (t_steady or t_wall0), 1e-9)
    summary = {
        "drain": args.drain,
        "buffers": n_bufs,
        "frames": n_frames,
        "crc_failures": n_crc_bad,
        "wall_s": round(wall, 4),
        "samples_per_s": round(n_bufs * buf_samples / wall, 1),
        "frames_per_s": round(n_frames / wall, 1),
        # rate excluding the first buffer (which carries first-call costs:
        # kernel builds, constant uploads)
        "steady_samples_per_s": round(steady_bufs * buf_samples
                                      / steady_wall, 1),
        "host_feed_s": round(t_feed, 4),
        "device_drain_s": round(t_drain, 4),
        "feed_bound": t_feed > 0.5 * wall,
    }
    if max_seq is not None:
        # device-side verification tallies (metadata drain): highest MAC seq
        # accepted, and a mod-2^32 checksum over all CRC-clean payload bytes
        # (wraps on long runs by design — it is an equality check against a
        # same-width reference sum, not a byte count).  max_seq is -1 when
        # no CRC-clean frame was decoded: the device maxes seq over
        # CRC-clean frames only, starting from 0, which would otherwise be
        # indistinguishable from 'frame with seq 0 arrived'
        summary["max_seq"] = max_seq if (n_frames - n_crc_bad) > 0 else -1
        summary["payload_checksum_u32"] = payload_sum
    if args.profile:
        # the recorder's counts and, on the card, each staged replay's
        # device time by stage (microseconds over the replays read)
        summary["trace_counts"] = recorded["counts"]
        summary["stage_device_us"] = stages
    if args.summary_json:
        text = json.dumps(summary)
        if args.summary_json == "-":
            print(text)
        else:
            with open(args.summary_json, "w") as f:
                f.write(text + "\n")

    if args.log:
        trace.to_log_txt(args.log)
    if args.metrics:
        with open(args.metrics, "w") as f:
            for r in metrics_rows:
                f.write(json.dumps(r) + "\n")
    print(f"decoded {n_frames} frames ({n_crc_bad} CRC failures) "
          f"-> {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
