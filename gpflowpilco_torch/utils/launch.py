"""Stall- and crash-restarting supervisor for the port's long runs
(counterpart of gpflowpilco_tpu/utils/launch.py).

A long run on the card can go silent or die for reasons outside the
program: the first use of the CUDA kernels builds them with ``nvcc`` (a
minute or more, silent), a device or driver fault can kill a process
mid-run, and a process killed before can still hold its device briefly,
so that the next one dies at start-up. The supervisor runs the command as a
subprocess in its own process group, forwards its combined output, and
restarts it (up to ``max_restarts`` times) when the output stays silent for
``stall_timeout`` seconds, killing the whole group, or when it exits
nonzero within its start-up window. A nonzero exit later in the run is
retried only ``late_crash_retries`` times: a loop with a checkpoint
directory (``PILCOBase``'s ``directory``, ``run_torch.py --dest``) resumes
from its last completed episode, so a restart repeats at most one episode.
The silence threshold must exceed the longest silent stretch of a healthy
run, the first kernel build included.

Usage:
    python -m gpflowpilco_torch.utils.launch [--stall-timeout 1800] \\
        [--max-restarts 2] -- python examples/cartpole_swingup/run_torch.py --dest DIR ...
"""
from __future__ import annotations

import argparse
import codecs
import os
import selectors
import signal
import subprocess
import sys
import time


def supervise(
    cmd: list[str],
    stall_timeout: float = 1800.0,
    max_restarts: int = 2,
    stdout=None,
    crash_backoff: float = 30.0,
    late_crash_retries: int = 0,
) -> int:
    """Run ``cmd``, restarting it (up to ``max_restarts`` times) when its
    combined stdout/stderr produces nothing for ``stall_timeout`` seconds,
    or when it exits nonzero within its start-up window (the larger of
    300 s and twice ``crash_backoff``), after waiting ``crash_backoff``
    seconds. A nonzero exit after that window is retried up to
    ``late_crash_retries`` times, after twice the backoff. Output is
    forwarded to ``stdout`` (default: this process's stdout). Returns the
    command's last exit code, or 124 if the last attempt stalled too."""
    out = stdout or sys.stdout
    reason = ""
    for attempt in range(max_restarts + 1):
        if attempt:
            print(f"[launch] restart {attempt}/{max_restarts} ({reason})", file=out, flush=True)
        start = time.monotonic()
        proc = subprocess.Popen(
            cmd,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            start_new_session=True,  # its own process group: the kill reaches its children
        )
        sel = selectors.DefaultSelector()
        sel.register(proc.stdout, selectors.EVENT_READ)
        # one incremental decoder across reads: a multi-byte UTF-8 character
        # split at a 64 KiB read boundary must not decode as two U+FFFDs
        decoder = codecs.getincrementaldecoder("utf-8")(errors="replace")
        stalled = False
        last_output = time.monotonic()
        while True:
            events = sel.select(timeout=min(stall_timeout, 60.0))
            if events:
                chunk = os.read(proc.stdout.fileno(), 65536)
                if chunk:
                    last_output = time.monotonic()
                    out.write(decoder.decode(chunk))
                    out.flush()
                    continue
                break  # EOF: the process finished or closed its streams
            if proc.poll() is not None:
                break
            if time.monotonic() - last_output > stall_timeout:
                stalled = True
                break
        sel.unregister(proc.stdout)
        out.write(decoder.decode(b"", final=True))
        if not stalled:
            # EOF proves only that the streams closed: a child that redirects
            # its output away and then hangs is still under the watchdog
            try:
                rc = proc.wait(timeout=stall_timeout)
            except subprocess.TimeoutExpired:
                stalled = True
            else:
                early = time.monotonic() - start < max(300.0, 2 * crash_backoff)
                if rc != 0 and early and attempt < max_restarts:
                    reason = f"exit {rc} within startup window"
                    print(f"[launch] {reason}; backing off {crash_backoff:.0f}s", file=out, flush=True)
                    time.sleep(crash_backoff)
                    continue
                if rc != 0 and not early and late_crash_retries > 0:
                    late_crash_retries -= 1
                    reason = f"late exit {rc}; resuming from checkpoint"
                    print(f"[launch] {reason}; backing off {2 * crash_backoff:.0f}s", file=out, flush=True)
                    time.sleep(2 * crash_backoff)
                    continue
                return rc
        if stalled:
            reason = f"{stall_timeout:.0f}s of silence"
            # kill the exact process group started here, never by pattern
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
            continue
    return 124


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--stall-timeout", type=float, default=1800.0)
    p.add_argument("--max-restarts", type=int, default=2)
    p.add_argument("--crash-backoff", type=float, default=30.0,
                   help="seconds to wait before retrying a crashed start")
    p.add_argument("--late-crash-retries", type=int, default=3,
                   help="also retry nonzero exits past the start-up window; safe for runs "
                        "that resume from their checkpoints")
    p.add_argument("cmd", nargs=argparse.REMAINDER, help="command to run (prefix with --)")
    args = p.parse_args(argv)
    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        p.error("no command given")
    return supervise(cmd, args.stall_timeout, args.max_restarts, crash_backoff=args.crash_backoff,
                     late_crash_retries=args.late_crash_retries)


if __name__ == "__main__":
    sys.exit(main())
