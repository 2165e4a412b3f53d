"""Trending items (PyTorch port): windowed vs all-time counts on a bursty
stream.

A catalogue of items receives Zipfian background traffic; partway
through, a handful of cold items go viral.  An all-time CML sketch keeps
ranking the long-term heads; a sliding-window ring (the last W intervals)
surfaces the burst within one rotation, and an exponentially decayed
sketch ranks by recency-weighted count (gamma^age applied at query time
by the window-query kernel): the three time semantics of the streaming
plane side by side, all constant memory.  Then the same workload through
`CountService`, whose heavy-hitter tracker serves the boards.  The same
stream and draws as `examples/trending_items.py`, so the same rankings.

    PYTHONPATH=src python examples/trending_items_torch.py [--rotations 12]
        [--per-rotation 8000] [--vocab 5000] [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import CMLS16, SketchSpec, prng
from repro_torch.core import sketch as sk
from repro_torch.core.counters import from_numpy
from repro_torch.core.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.stream import (CountService, WindowSpec, decayed_init,
                                decayed_query, decayed_update, window_init,
                                window_query, window_rotate, window_update)

BURST_ITEMS = np.arange(4900, 4910, dtype=np.uint32)  # cold tail ids
INTERVAL = 60.0
BOARD_KW = {"alltime": {}, "trending(3)": {"n_buckets": 3},
            "trend(g=.7)": {"gamma": 0.7}}


def _rotation_events(rng, r: int, burst_start: int, args) -> np.ndarray:
    ev = (rng.zipf(1.3, args.per_rotation) % args.vocab).astype(np.uint32)
    if r >= burst_start:  # the burst: each viral item spikes hard
        ev = np.concatenate([ev, np.repeat(BURST_ITEMS, 400)])
        rng.shuffle(ev)
    return ev


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rotations", type=int, default=12)
    ap.add_argument("--per-rotation", type=int, default=8000)
    ap.add_argument("--vocab", type=int, default=5000)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    burst_start = args.rotations - 3                   # viral in the last 3

    spec = SketchSpec(width=8192, depth=4, counter=CMLS16)
    win = window_init(WindowSpec(sketch=spec, buckets=8), device=dev)
    alltime = sk.init(spec, device=dev)
    decayed = decayed_init(spec, gamma=0.7, history=8, device=dev)

    rng = np.random.default_rng(0)
    key = np.array([0, 0], np.uint32)
    for r in range(args.rotations):
        ev = from_numpy(_rotation_events(rng, r, burst_start, args), dev)
        key, k1, k2, k3 = prng.split(key, 4)
        win = window_update(win, ev, k1)
        alltime = sk.update_batched(alltime, ev, k2)
        decayed = decayed_update(decayed, ev, k3)
        if r < args.rotations - 1:
            win = window_rotate(win)

    probe = from_numpy(np.arange(args.vocab, dtype=np.uint32), dev)
    scores = {
        "all-time": ops.query(alltime, probe).cpu().numpy(),
        "window(3)": window_query(win, probe, n_buckets=3).cpu().numpy(),
        "decayed(g=0.7)": decayed_query(decayed, probe).cpu().numpy(),
    }

    print(f"burst items {BURST_ITEMS[0]}..{BURST_ITEMS[-1]} went viral in "
          f"the last {args.rotations - burst_start} of {args.rotations} "
          f"intervals\n")
    print(f"{'rank':>4}  {'all-time':>10}  {'window(3)':>10}  "
          f"{'decayed':>10}")
    ranked = {name: np.argsort(-s)[:10].tolist() for name, s in
              scores.items()}
    for i in range(10):
        row = [ranked[name][i] for name in scores]
        print(f"{i + 1:>4}  " + "  ".join(f"{int(x):>10}" for x in row))
    hits = {}
    for name in scores:
        hits[name] = len(set(ranked[name]) & set(BURST_ITEMS.tolist()))
        print(f"\n{name:>14}: {hits[name]}/10 of top-10 are burst items")

    # the same workload through CountService: an all-time tenant and a
    # watermark-windowed trending tenant (the window rotates from event
    # timestamps); track_top=16 serves the boards from the device-resident
    # heavy-hitter tracker, with no sweep of the catalogue
    svc = CountService(spec, queue_capacity=1 << 15, track_top=16,
                       device=dev)
    svc.add_tenant("alltime")
    svc.add_tenant("trending", window=WindowSpec(sketch=spec, buckets=8,
                                                 interval=INTERVAL))
    rng = np.random.default_rng(0)
    for r in range(args.rotations):
        ev = _rotation_events(rng, r, burst_start, args)
        ts = (r + 0.5) * INTERVAL  # event time drives the window's rotation
        svc.enqueue("alltime", ev)
        svc.enqueue("trending", ev, ts=ts)

    print(f"\nCountService replay (watermark epoch "
          f"{svc.epoch_of('trending')}, {svc.stats['flushes']} fused "
          f"flushes):")
    boards = {
        "alltime": svc.topk("alltime", 10),
        "trending(3)": svc.topk("trending", 10, n_buckets=3),
        "trend(g=.7)": svc.topk("trending", 10, gamma=0.7),
    }
    print(f"{'rank':>4}  " + "  ".join(f"{n:>12}" for n in boards))
    for i in range(10):
        row = [int(keys[i]) if i < len(keys) else -1
               for keys, _ in boards.values()]
        print(f"{i + 1:>4}  " + "  ".join(f"{x:>12}" for x in row))
    board_hits = {}
    for name, (keys, est) in boards.items():
        board_hits[name] = len(set(int(k) for k in keys[:10])
                               & set(BURST_ITEMS.tolist()))
        print(f"{name:>12}: {board_hits[name]}/10 of svc.topk(10) are "
              f"burst items")
        # tracker estimates are the sketch's own answers, exactly
        tenant = "alltime" if name == "alltime" else "trending"
        answers = svc.query(tenant, keys, **BOARD_KW[name]).cpu().numpy()
        assert (est == answers).all(), name
    return {"ranked": ranked, "hits": hits, "scores": scores,
            "boards": {n: [int(k) for k in keys]
                       for n, (keys, _) in boards.items()},
            "board_estimates": {n: [float(e) for e in est]
                                for n, (_, est) in boards.items()},
            "board_hits": board_hits,
            "epoch": svc.epoch_of("trending"),
            "flushes": int(svc.stats["flushes"])}


if __name__ == "__main__":
    main()
