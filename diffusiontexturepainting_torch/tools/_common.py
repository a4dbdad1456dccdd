"""What the A/B entry points of this package share: the --device, --shapes
and --json-out arguments, the refusal to time without a card, CUDA-event
timing (of eager calls, and of the same calls replayed from a CUDA graph)
and the JSON record."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

CALLS, TRIES = 20, 4


def parse_args(doc: str, shape_sets, default: str, argv=None, extra=()):
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--shapes", default=default, choices=sorted(shape_sets))
    ap.add_argument("--json-out", default=None,
                    help="also write the JSON record to this file")
    for flag, kw in extra:
        ap.add_argument(flag, **kw)
    return ap.parse_args(argv)


def open_device(args, prog: str):
    """(ok, card): without a card and without --device cpu, ok is False;
    card is nvidia-smi's name and power limit, None on the CPU."""
    if args.device == "cpu":
        return True, None
    if not torch.cuda.is_available():
        print(f"{prog}: no CUDA device (use --device cpu --shapes tiny for "
              "the plain versions)", file=sys.stderr)
        return False, None
    # fp32 yardsticks and plain versions in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)} ({card})", flush=True)
    return True, card


def event_ms(fn, calls: int = CALLS, tries: int = TRIES) -> float:
    """Best of `tries` CUDA-event timings of `calls` back-to-back calls of
    fn, after one warm-up call; ms a call."""
    fn()
    best = float("inf")
    for _ in range(tries):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / calls)
    return best


def graph_ms(fn, calls: int = CALLS, tries: int = TRIES) -> float:
    """Best of `tries` CUDA-event timings of one replay of a CUDA graph that
    holds `calls` back-to-back calls of fn, after one warm-up call; ms a
    call. The device's time alone: event_ms also counts the host's launch
    cost, which is most of a call of a few tens of microseconds."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    best = float("inf")
    for _ in range(tries):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / calls)
    del graph
    return best


def max_diff(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def fill_count(blocks_per_item: int) -> int:
    """How many items of `blocks_per_item` blocks give the card two blocks
    an SM (1 on the CPU)."""
    if not torch.cuda.is_available():
        return 1
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return -(-2 * sms // max(1, blocks_per_item))


def fmt(x, spec: str) -> str:
    return "-" if x is None else format(x, spec)


def emit(args, card, rows, **extra) -> int:
    record = {"device": (torch.cuda.get_device_name(0)
                         if args.device == "cuda" else "cpu"),
              "card": card, **extra, "rows": rows}
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(record, f)
    print(json.dumps(record), flush=True)
    return 0
