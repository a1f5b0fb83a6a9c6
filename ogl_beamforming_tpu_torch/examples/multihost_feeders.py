"""Multi-host feeder pattern: one RF feeder per host, one global volume.

Run ONE copy of this module per feeder host (the group's address is process
0's ``HOST:PORT``):

    python -m ogl_beamforming_tpu_torch.examples.multihost_feeders \
        --coordinator HOST0:8476 --num-hosts 4 --host-id $ID

Each host's acquisition front end owns the channel rows cabled to it
(``local_channel_slice``); they are placed on that host's cards only
(``feed_rf``) and the DAS partial volumes are summed across hosts by
``torch.distributed`` (``--backend``: ``nccl`` for cards, ``gloo`` also
runs on the CPU).  On one machine it degenerates to one feeder over the
local cards (``--device cuda``, the default, takes every visible one), so
the same script runs everywhere.

See parallel/multihost.py for the mechanics; the port's tests hold the fed
pipeline against the unsharded plan on a CPU mesh and across two processes.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default=None,
                    help="HOST:PORT of process 0 (omit for single-host)")
    ap.add_argument("--num-hosts", type=int, default=1)
    ap.add_argument("--host-id", type=int, default=0)
    ap.add_argument("--channels", type=int, default=256)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (every visible card), cuda:N or cpu")
    args = ap.parse_args(argv)

    from ..models.presets import plane_wave_2d
    from ..parallel import multihost, sharding
    from ..pipeline.plan import build_plan
    from ..utils.device import sync

    multihost.init_multihost(args.coordinator, args.num_hosts, args.host_id,
                             backend=args.backend)
    mesh = multihost.make_host_mesh(
        devices=None if args.device == "cuda" else [args.device])
    home = mesh.home()
    if home.type == "cuda":
        torch.cuda.set_device(home)
    rank = sharding.world()[0]
    print(f"host {rank}/{args.num_hosts}: {len(mesh.local())} local of "
          f"{mesh.size} positions ({home})")

    c, s = args.channels, 4096
    p, pipe = plane_wave_2d(channel_count=c, sample_count=s)
    splan = sharding.shard_plan(build_plan(p, pipe, {}, device=home), mesh)
    sl = multihost.local_channel_slice(c)
    rng = np.random.default_rng(rank)

    for i in range(args.frames):
        # this host's feeder produces ONLY its own channel rows
        local_rows = rng.standard_normal(
            (sl.stop - sl.start, 1, s)).astype(np.float32)
        t0 = time.perf_counter()
        out = splan(multihost.feed_rf(local_rows, mesh))
        sync(out)
        frame = multihost.gathered_frame(out)
        assert np.isfinite(frame).all()
        print(f"frame {i}: {frame.shape} in "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
