"""Counts the rounds in which a spawned rank dies, under the layout of the
repo's tier-1 run: pytest with ``-p xdist -n 6 --dist loadfile`` and
``JAX_PLATFORMS=cpu`` over every test file that spawns ranks
(``dist.launch.spawn_ranks``), plus three long tier-1 files so that the
8 cores are as loaded as in the whole run.

    python torch_records/spawn_steadiness.py --rounds 30 \\
        [--repo DIR [DIR ...]] [--logs DIR] [--debug-malloc] [--backtrace]

``--repo`` names the checkouts whose tests run (default: this one), so
that a parent commit unpacked elsewhere runs under the same command; with
several, each round runs them in turn, so that they share the machine's
conditions.  Each round's pytest output goes to
``LOGS/<checkout>/round_NN.log``; one JSON line per round and checkout,
and a summary per checkout, go to stdout.  A round has a dead rank when
its log says a spawned process ended by a signal or an exit code (the
words of ``torch.multiprocessing`` and of ``spawn_ranks``); the rounds in
which a rank could not bind its rendezvous port (EADDRINUSE) are counted
apart.  ``--scan LOG ...`` reads kept logs again.

``--debug-malloc`` runs with ``MALLOC_CHECK_=3`` (glibc's checking
allocator, which needs ``libc_malloc_debug.so.0`` preloaded since glibc
2.34), ``MALLOC_PERTURB_=165`` and ``PYTHONFAULTHANDLER=1``, which make a
write to freed memory show earlier and print the Python stack of an
aborting process.  ``--backtrace`` builds ``abort_backtrace.c`` with gcc
and preloads it, and sets ``PYTHONFAULTHANDLER=1``, so that an aborting
process prints its native frames and its Python stack; neither changes
how memory is allocated.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import xml.etree.ElementTree as ET

HERE = os.path.dirname(os.path.abspath(__file__))

SPAWNING = ["tests/test_torch_dist.py", "tests/test_torch_dist_batch.py",
            "tests/test_torch_dist_own.py",
            "tests/test_torch_checkpoint_sharded.py",
            "tests/test_torch_repairs.py"]
WORKERS = 6
LOAD = ["tests/test_torch_batch_search.py",
        "tests/test_torch_batch_search_loops.py",
        "tests/test_torch_batch_search_solve.py"]

DEAD = re.compile(r"terminated with (signal \w+|exit code \d+)")
HEAP = re.compile(r"malloc\(\)|free\(\)|double free|corrupted|tcache|"
                  r"malloc_consolidate|munmap_chunk")
SUMMARY = re.compile(r"(\d+) (passed|failed|errors?)")


def environment(debug_malloc: bool, preload: list) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu", ALLOW_MULTIPLE_LIBTPU_LOAD="1")
    if preload:
        env["PYTHONFAULTHANDLER"] = "1"
    if debug_malloc:
        env.update(MALLOC_CHECK_="3", MALLOC_PERTURB_="165",
                   PYTHONFAULTHANDLER="1")
        preload = ["libc_malloc_debug.so.0"] + preload
    if preload:
        env["LD_PRELOAD"] = " ".join(preload)
    return env


def build_backtrace(logs: str) -> str:
    lib = os.path.join(logs, "abort_backtrace.so")
    subprocess.run(["gcc", "-shared", "-fPIC", "-O1", "-o", lib,
                    os.path.join(HERE, "abort_backtrace.c")], check=True)
    return lib


def one_round(repo: str, env: dict, log: str) -> dict:
    cmd = [sys.executable, "-m", "pytest", *SPAWNING, *LOAD, "-q",
           "-m", "not slow", "-p", "no:cacheprovider", "-p", "xdist",
           "-n", str(WORKERS),
           "--dist", "loadfile", "-p", "no:randomly",
           f"--junitxml={log[:-len('.log')]}.xml"]
    t0 = time.time()
    with open(log, "w") as fh:
        rc = subprocess.run(cmd, cwd=repo, env=env, stdout=fh,
                            stderr=subprocess.STDOUT).returncode
    return dict(rc=rc, seconds=round(time.time() - t0, 1), **scan(log))


def scan(log: str) -> dict:
    """What a round's log says: pytest's counts, whether a spawned rank
    ended by a signal or an exit code (``dead_rank``, and the endings), the
    lines of glibc's heap checks, whether a rank's rendezvous port was
    taken (``port_clash``), and each file's seconds."""
    with open(log, errors="replace") as fh:
        text = fh.read()
    counts = {"passed": 0, "failed": 0, "errors": 0}
    tail = text.strip().splitlines()[-1] if text.strip() else ""
    for n, word in SUMMARY.findall(tail):
        counts["errors" if word.startswith("error") else word] = int(n)
    dead = sorted(set(m.group(1) for m in DEAD.finditer(text)))
    return dict(**counts, dead_rank=bool(dead), ends=dead,
                heap_messages=len(HEAP.findall(text)),
                port_clash="EADDRINUSE" in text,
                file_seconds=file_seconds(log[:-len(".log")] + ".xml"))


def file_seconds(xml: str) -> dict:
    """Each test file's summed test time in a round's junit XML (with
    ``--dist loadfile`` one worker runs a file, so this is its wall
    time, its fixtures included)."""
    out = {}
    try:
        root = ET.parse(xml).getroot()
    except (OSError, ET.ParseError):
        return out
    for case in root.iter("testcase"):
        name = case.get("classname", "").split(".")[-1] + ".py"
        out[name] = out.get(name, 0.0) + float(case.get("time", 0.0))
    return {k: round(v, 1) for k, v in sorted(out.items())}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--repo", nargs="+", default=[os.path.dirname(HERE)])
    ap.add_argument("--logs", default=os.path.join(tempfile.gettempdir(),
                                                   "spawn_steadiness"))
    ap.add_argument("--debug-malloc", action="store_true")
    ap.add_argument("--backtrace", action="store_true")
    ap.add_argument("--scan", nargs="+", metavar="LOG",
                    help="only read these round logs again and print "
                         "their rows")
    args = ap.parse_args(argv)
    if args.scan:
        rows = [dict(log=log, **scan(log)) for log in args.scan]
        for row in rows:
            print(json.dumps(row))
        return rows
    os.makedirs(args.logs, exist_ok=True)
    preload = [build_backtrace(args.logs)] if args.backtrace else []
    env = environment(args.debug_malloc, preload)
    repos = [os.path.abspath(r) for r in args.repo]
    dead_rounds = {r: [] for r in repos}
    clashes = {r: 0 for r in repos}
    seconds = {r: 0.0 for r in repos}
    for k in range(args.rounds):
        for i, repo in enumerate(repos):
            logs = os.path.join(args.logs, f"{i}_{os.path.basename(repo)}")
            os.makedirs(logs, exist_ok=True)
            row = one_round(repo, env,
                            os.path.join(logs, f"round_{k:02d}.log"))
            row.update(round=k, repo=repo)
            print(json.dumps(row), flush=True)
            seconds[repo] += row["seconds"]
            if row["dead_rank"]:
                dead_rounds[repo].append(k)
            clashes[repo] += row["port_clash"]
    summaries = [{"repo": repo, "rounds": args.rounds,
                  "dead_rounds": len(dead_rounds[repo]),
                  "which": dead_rounds[repo],
                  "port_clash_rounds": clashes[repo], "workers": WORKERS,
                  "files": SPAWNING + LOAD, "debug_malloc": args.debug_malloc,
                  "backtrace": args.backtrace,
                  "seconds": round(seconds[repo], 1)} for repo in repos]
    for summary in summaries:
        print(json.dumps(summary), flush=True)
    return summaries


if __name__ == "__main__":
    main()
