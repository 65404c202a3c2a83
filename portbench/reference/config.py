"""The modem geometry the benchmark's traffic and reference are built from.

A frozen copy of the fields and derived sizes of the port's
``config.py::ModemConfig`` (the reference C-OFDM modem's keys,
`config/parser.cpp:4-33`, `config/config.txt:1-32`), so that nothing under
``reference/`` or ``traffic/`` imports the program.  A configuration file
under ``configs/`` gives the keyword arguments of both this class and the
program's ``ModemConfig``; the radio and sync-threshold keys are carried so
that the same arguments are accepted, and only the geometry is read here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModemConfig:
    fft_size: int = 512
    num_data_subc: int = 256
    num_pilot_subc: int = 8
    cp_size: int = 128
    num_symb: int = 8
    num_pr_symb: int = 1
    pr_sin_len: int = 128
    pr_seed: int = 42
    pr_level: float = 0.5
    t2sin_size: int = 256
    t2_sin_f1: int = 17
    t2_sin_f2: int = 51
    t2_sin_level: float = 0.8
    smooth: int = 5
    mod_type: int = 4
    pilot_ampl: float = 2.5
    cfo_outlier_bins: int = 6
    t2_gate_level: Optional[float] = None
    sync_peak_refine: Optional[bool] = None
    t2_gate_slack: int = 8
    bw_hz: int = 10_000_000
    fs_hz: int = 5_000_000
    lo_hz: int = 2_800_000_000
    hardwaregain: int = 50
    mult: int = 200
    rx_buf_size: int = 40
    tx_cycle_buf: int = 0
    tx_time_int: int = 0
    iterations: int = 10_000

    def __post_init__(self):
        if self.num_data_subc % self.num_pilot_subc or self.num_pilot_subc % 2:
            raise ValueError("num_data_subc must split into num_pilot_subc "
                             "segments, and num_pilot_subc must be even")
        if self.num_data_subc + self.num_pilot_subc >= self.fft_size:
            raise ValueError("data + pilot subcarriers must fit below fft_size")
        if self.mod_type not in (1, 2, 4, 6, 8):
            raise ValueError(f"unsupported mod_type {self.mod_type}")
        if (self.num_data_subc * self.num_symb * self.mod_type) % 8:
            raise ValueError("frame payload must be a whole number of bytes")

    @property
    def segment_step(self) -> int:
        return self.num_data_subc // self.num_pilot_subc + 1

    @property
    def segment_size(self) -> int:
        return self.segment_step - 1

    @property
    def ofdm_len(self) -> int:
        return self.fft_size + self.cp_size

    @property
    def preamble_len(self) -> int:
        return self.ofdm_len * self.num_pr_symb

    @property
    def message_len(self) -> int:
        return self.ofdm_len * self.num_symb

    @property
    def frame_len(self) -> int:
        """Samples a frame: two-tone burst + preamble + message."""
        return self.t2sin_size + self.preamble_len + self.message_len

    @property
    def frame_bytes(self) -> int:
        return self.num_data_subc * self.num_symb * self.mod_type // 8

    @property
    def preamble_bytes(self) -> int:
        return self.num_data_subc * self.num_pr_symb // 8

    @property
    def buffer_len(self) -> int:
        """Samples an ingest buffer: ``rx_buf_size`` frame lengths."""
        return self.rx_buf_size * self.frame_len
