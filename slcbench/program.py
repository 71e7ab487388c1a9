"""The system under test: ``slc_tpu_torch``'s public functions, called in
the order and with the arguments that ``slc_tpu_torch.runner.
run_replay`` uses in stream mode (``stream=True``, ``chunk=1``, lock
"auto", clouds off), with inputs from host memory instead of a dataset.

Every call looks its function up on the program's module at call time,
so a test can put a broken function in its place.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

import slc_tpu_torch.calib as pcalib
import slc_tpu_torch.config as pconfig
import slc_tpu_torch.dynamic as pdynamic
import slc_tpu_torch.pipeline as ppipeline
import slc_tpu_torch.streaming as pstreaming
from slc_tpu_torch.ops import demod as pdemod


class Program:
    """One configuration's program state: the system configuration, the
    triangulation tables on the device and one frame stager, built once
    as a long-running capture process builds them."""

    def __init__(self, config: dict, cal: Dict[str, np.ndarray], device):
        self.device = torch.device(device)
        s = config["system"]
        self.cfg = pconfig.SystemConfig(**s)
        self.mode = config["decode"]
        if self.mode == "heterodyne":
            h = config["heterodyne"]
            self.het = pconfig.HeterodyneConfig(
                fringe_counts=tuple(h["fringe_counts"]),
                phase_steps=h["phase_steps"])
            self.min_modulation = h["min_modulation"]
        elif self.mode != "grayphase":
            raise ValueError(f"unknown decode {self.mode!r}")
        self.track = config["tracker"]
        self.period = float(config["stripe_period"])
        self.win_v = int(config["lock_win_v"])
        calib = pcalib.Calibration.from_numpy(cal["cam_k"], cal["pro_k"],
                                              cal["rot"], cal["trans"])
        self.tables = pcalib.build_tables(calib, s["cam_h"], s["cam_w"],
                                          self.device)
        self.stager = pstreaming.HostStager(self.device)

    def to_dev(self, a: np.ndarray) -> torch.Tensor:
        """``run_replay``'s ``to_dev``: a pageable copy to the device."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def upload(self, parts: List[np.ndarray]) -> List[torch.Tensor]:
        """The frame-0 pattern stack to the device, part by part (Gray and
        phase images; or the fringe stack)."""
        return [self.to_dev(p) for p in parts]

    def decode(self, parts: List[torch.Tensor]):
        """The configuration's absolute decode -> FrameResult."""
        if self.mode == "grayphase":
            return ppipeline.decode_first_frame(parts[0], parts[1],
                                                self.tables, self.cfg)
        return ppipeline.decode_heterodyne_frame(
            parts[0], self.tables, self.cfg, self.het, self.min_modulation)

    @staticmethod
    def fetch(res) -> torch.Tensor:
        """z on the host: ``streaming.fetch_z_async``, waited on."""
        return pstreaming.fetch_z_async(res).z

    def lock_window(self, pu_host: np.ndarray) -> int:
        """The demod window suggested from the frame-0 map on the host."""
        return pdemod.suggest_lock_window(pu_host, self.period)

    def estimate_period(self, frame0: np.ndarray, proj_u: torch.Tensor,
                        win: int) -> float:
        """``run_replay``'s period diagnostic from the first frame."""
        return float(pdemod.estimate_period(self.to_dev(frame0), proj_u,
                                            self.period, win_u=win))

    def init_tracker(self, frame0: np.ndarray, first):
        return pdynamic.init_tracker(self.to_dev(frame0), first.proj_u,
                                     first.z, self.cfg,
                                     self.track["subpixel"])

    def warm_host_blocks(self, n: int) -> None:
        """Fill the pinned host allocator's cache with ``n`` blocks of a
        depth map's size, so that fetches whose maps are kept for the
        check allocate nothing in the window."""
        s = self.cfg
        blocks = [torch.empty((s.cam_h, s.cam_w), dtype=torch.float32,
                              pin_memory=self.device.type == "cuda")
                  for _ in range(n)]
        del blocks

    def step(self, state, frame: torch.Tensor, win: int):
        t = self.track
        return pdynamic.dynamic_step(
            state, frame, self.tables, self.cfg, t["scale_gradient"],
            t["subpixel"], t["robust"], phase_lock=self.period,
            lock_win_u=win, lock_win_v=self.win_v,
            frac_bits=t["frac_bits"])
