"""Run a command in a session of its own and list the processes of that
session still alive 0, 1 and 5 s after it exits (then kill them).

    python3 scripts/torch_session_leftovers.py python3 chip_smoke.py

The command's output passes through. Exits with the command's code, or 1
if it exited 0 but left a process running (a loader's fork server, a
worker, a compiler). Linux only: it reads `/proc/<pid>/stat`.
"""
import os
import signal
import subprocess
import sys
import time


def session_processes(sid: int) -> list:
    """(pid, state, command line) of every live process in session `sid`."""
    found = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                stat = f.read()
            fields = stat[stat.rindex(")") + 2:].split()
            if int(fields[3]) == sid and fields[0] != "Z":
                with open(f"/proc/{name}/cmdline", "rb") as f:
                    cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
                found.append((int(name), fields[0], cmd[:200]))
        except (OSError, ValueError):
            pass  # ended while being read
    return found


def main(argv: list) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, start_new_session=True)
    rc = proc.wait()
    print(f"session_leftovers: exit {rc} after "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    ever_left = False
    for wait in (0, 1, 4):
        time.sleep(wait)
        left = session_processes(proc.pid)
        ever_left = ever_left or bool(left)
        print(f"session_leftovers: left at {time.perf_counter() - t0:.2f} s: "
              f"{left}", flush=True)
    for pid, _, _ in left:
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    return rc or (1 if ever_left else 0)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
