"""The port's run supervisor (gpflowpilco_torch/utils/launch.py):
forwarding, exit codes, the kill-and-restart on silence and the retry of
an early crash, at stall timeouts of a second or two. Subprocesses only,
no JAX and no torch in the supervised commands."""
import io
import sys

from gpflowpilco_torch.utils.launch import main, supervise


def test_torch_launch_forwards_output_and_exit_code():
    buf = io.StringIO()
    rc = supervise([sys.executable, "-c", "print('h\\u00e9llo'); raise SystemExit(7)"],
                   stall_timeout=30.0, max_restarts=0, stdout=buf)
    assert rc == 7
    assert "héllo" in buf.getvalue()


def test_torch_launch_stall_restarts_then_succeeds(tmp_path):
    """The first attempt finds no marker, prints and hangs silently; the
    supervisor kills its process group, and the retry (marker present)
    exits 0: a resumed run in miniature. The silence clock starts at
    launch, so the timeout must exceed the interpreter's start."""
    marker = tmp_path / "ckpt"
    script = (
        "import os, sys, time\n"
        f"m = {str(marker)!r}\n"
        "if os.path.exists(m):\n"
        "    print('resumed'); sys.exit(0)\n"
        "open(m, 'w').close()\n"
        "print('cold', flush=True)\n"
        "time.sleep(300)\n"
    )
    buf = io.StringIO()
    rc = supervise([sys.executable, "-c", script], stall_timeout=2.0, max_restarts=1, stdout=buf)
    assert rc == 0
    text = buf.getvalue()
    assert "cold" in text and "resumed" in text and "restart 1/1" in text


def test_torch_launch_persistent_stall_returns_124():
    buf = io.StringIO()
    rc = supervise([sys.executable, "-c", "import time; time.sleep(300)"], stall_timeout=1.0,
                   max_restarts=1, stdout=buf)
    assert rc == 124
    assert "1s of silence" in buf.getvalue()


def test_torch_launch_early_crash_retries(tmp_path, capsys):
    """An exit 1 at start-up (a device still held by a killed predecessor)
    is retried after the backoff; the retry succeeds. Through ``main``,
    as ``python -m gpflowpilco_torch.utils.launch`` runs it."""
    marker = tmp_path / "claim"
    script = (
        "import os, sys\n"
        f"m = {str(marker)!r}\n"
        "if os.path.exists(m):\n"
        "    print('claimed'); sys.exit(0)\n"
        "open(m, 'w').close()\n"
        "print('busy', flush=True)\n"
        "sys.exit(1)\n"
    )
    rc = main(["--stall-timeout", "30", "--max-restarts", "2", "--crash-backoff", "0.1", "--",
               sys.executable, "-c", script])
    assert rc == 0
    text = capsys.readouterr().out
    assert "exit 1 within startup window" in text and "claimed" in text
