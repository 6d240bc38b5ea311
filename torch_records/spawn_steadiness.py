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

``--own`` is the narrow mode: each round repeats only the caller's
own-objective job of ``tests/test_torch_dist_own.py``, through that
module's ``_solve``: the cases ``--cases`` names (default its two bounded
batch cases, ``OWN_CASES``, where a gloo rank aborted on a corrupted
heap; ``all`` for every case in its order) ``--repeat`` times per spawn
of its 4 gloo ranks, in ``--jobs`` spawns at once, with the ``LOAD``
files running beside them under ``--load``.  ``--inflight K`` wraps the
job's objectives by ``inflight_objective``, which asks DTensor for K
asynchronous all-gathers before reading any.  A parent commit and
this checkout in turns:

    python torch_records/spawn_steadiness.py --own --cases rosenbrock-256 \\
        rosenbrock-261 --inflight 8 --repeat 4 --jobs 2 --load \\
        --backtrace --rounds 12 --repo PARENT_COPY . [--logs DIR]

The ranks run this file's ``own_rank`` on each checkout's own test module
and port, so that a parent commit runs the same job.  Each spawn's output
goes to ``LOGS/<checkout>/round_NN_jobJ.log``; a round has a dead rank
when one of its spawns names one.  A spawn also reports, per rank, the
largest number of native collectives still unwaited
(``_get_work_registry_size``) after any evaluation of the solve, and after
each solve.

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
import signal
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


OWN_CASES = ("batch-rosenbrock-bounded-256", "batch-rosenbrock-bounded-261")
OWN_RANKS = 4


def inflight_objective(f, k: int):
    """``f`` on ``k`` asynchronous all-gathers of the DTensor x, all asked
    for before any is read (``redistribute(..., async_op=True)``), so that
    ``k`` of PyTorch's native collectives are in flight on the rank's
    group at once.  Its value is ``f`` of the whole x."""
    def g(x):
        from torch.distributed.tensor import DTensor, Replicate

        if not isinstance(x, DTensor):
            return f(x)
        whole = [x.redistribute(placements=[Replicate()] * x.device_mesh.ndim,
                                async_op=True) for _ in range(k)]
        value = f(whole[0])
        for w in whole[1:]:
            value = value + 0.0 * w[..., 0]
        return value
    return g


def own_rank(rank: int, size: int, names: list, repeat: int,
             inflight: int) -> dict:
    """A rank of the narrow job: each of ``names`` (cases of
    ``tests/test_torch_dist_own.py``) ``repeat`` times through that
    module's ``_solve``, its objectives wrapped by ``inflight_objective``
    where ``inflight`` is not 0, counting after every evaluation of the
    caller's objective, and after every solve, the native functional
    collectives not yet waited for."""
    import torch

    from tests import test_torch_dist_own as own
    from tpu_lbfgs_torch import dist as tdist
    from tpu_lbfgs_torch.dist import sharded

    registry = getattr(torch._C._distributed_c10d,
                       "_get_work_registry_size", lambda: -1)
    seen = {"evaluations": 0, "pending_max": 0, "pending_evaluations": 0}

    def counted(make):
        def made(*args, **kwargs):
            fn = make(*args, **kwargs)

            def call(*xs):
                out = fn(*xs)
                pending = registry()
                seen["evaluations"] += 1
                seen["pending_max"] = max(seen["pending_max"], pending)
                seen["pending_evaluations"] += pending > 0
                return out
            return call
        return made

    sharded.partitioned_value = counted(sharded.partitioned_value)
    sharded.partitioned_value_and_grad = counted(
        sharded.partitioned_value_and_grad)
    if inflight:
        for key, f in list(own.OBJECTIVES.items()):
            own.OBJECTIVES[key] = inflight_objective(f, inflight)
    meshes = {"1d": tdist.make_mesh(), "2d": tdist.make_mesh_2d(own.ROWS)}
    after_solves = []
    for _ in range(repeat):
        for name in names:
            own._solve(own.BY_NAME[name], meshes)
            after_solves.append(registry())
    meshes.clear()
    return dict(seen, pending_after_solves=max(after_solves))


def own_job(spec: dict) -> None:
    """One spawn of the narrow job (``spec``: ``cases``, ``repeat``,
    ``inflight``) in the checkout this process runs in (its working
    directory); prints one JSON line."""
    sys.path.insert(0, os.getcwd())
    from tests.test_torch_dist_own import NAMES
    from tpu_lbfgs_torch.dist.launch import spawn_ranks

    names = list(NAMES) if spec["cases"] == ["all"] else spec["cases"]
    t0 = time.time()
    try:
        outs = spawn_ranks(own_rank, OWN_RANKS, names, spec["repeat"],
                           spec["inflight"], backend="gloo", timeout_s=180.0,
                           threads=1)
        row = dict(ok=True, ranks=outs)
    except RuntimeError as e:
        row = dict(ok=False, error=str(e)[:2000])
    print(json.dumps(dict(row, seconds=round(time.time() - t0, 1))),
          flush=True)


def own_round(repo: str, env: dict, log: str, spec: dict, jobs: int,
              load: bool) -> dict:
    """One round of the narrow mode: ``jobs`` spawns of the narrow job
    (``spec``) at once, with the ``LOAD`` files beside them under ``load``
    (stopped when the spawns end)."""
    t0 = time.time()
    loader = None
    if load:
        load_log = open(log[:-len(".log")] + "_load.log", "w")
        loader = subprocess.Popen(
            [sys.executable, "-m", "pytest", *LOAD, "-q", "-p",
             "no:cacheprovider", "-p", "xdist", "-n", str(len(LOAD)),
             "--dist", "loadfile", "-p", "no:randomly"],
            cwd=repo, env=env, stdout=load_log, stderr=subprocess.STDOUT,
            start_new_session=True)
    logs = [log[:-len(".log")] + f"_job{j}.log" for j in range(jobs)]
    handles = [open(path, "w") for path in logs]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--own-job",
         json.dumps(spec)], cwd=repo, env=env, stdout=fh,
        stderr=subprocess.STDOUT) for fh in handles]
    rcs = [p.wait() for p in procs]
    for fh in handles:
        fh.close()
    if loader is not None:
        try:
            os.killpg(loader.pid, signal.SIGTERM)
        except ProcessLookupError:
            pass
        loader.wait()
        load_log.close()
    row = dict(rc=max(rcs), seconds=round(time.time() - t0, 1))
    scans = [scan(path) for path in logs]
    ranks = [rank for path in logs for rank in job_ranks(path)]
    row.update(dead_rank=any(s["dead_rank"] for s in scans),
               dead_jobs=sum(s["dead_rank"] for s in scans),
               ends=sorted(set(e for s in scans for e in s["ends"])),
               heap_messages=sum(s["heap_messages"] for s in scans),
               port_clash=any(s["port_clash"] for s in scans),
               pending_max=max((r["pending_max"] for r in ranks),
                               default=None),
               pending_after_solves=max(
                   (r["pending_after_solves"] for r in ranks),
                   default=None),
               evaluations=sum(r["evaluations"] for r in ranks))
    return row


def job_ranks(log: str) -> list:
    """The ranks' reports in a narrow job's log (none if it failed)."""
    with open(log, errors="replace") as fh:
        for line in fh:
            if line.startswith("{"):
                try:
                    return json.loads(line).get("ranks", [])
                except ValueError:
                    pass
    return []


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
    if tail.startswith("{"):     # a narrow job's line, not pytest's
        tail = ""
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
    ap.add_argument("--own", action="store_true",
                    help="the narrow mode: only the own-objective job's "
                         "bounded batch cases")
    ap.add_argument("--repeat", type=int, default=8)
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--load", action="store_true")
    ap.add_argument("--cases", nargs="+", default=list(OWN_CASES),
                    help="with --own: the cases of tests/"
                         "test_torch_dist_own.py to repeat (all: every "
                         "case, in its order)")
    ap.add_argument("--inflight", type=int, default=0,
                    help="with --own: wrap the objectives by "
                         "inflight_objective with this many all-gathers")
    ap.add_argument("--own-job", metavar="SPEC", help=argparse.SUPPRESS)
    ap.add_argument("--scan", nargs="+", metavar="LOG",
                    help="only read these round logs again and print "
                         "their rows")
    args = ap.parse_args(argv)
    if args.own_job:
        own_job(json.loads(args.own_job))
        return []
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
    dead_jobs = {r: 0 for r in repos}
    clashes = {r: 0 for r in repos}
    seconds = {r: 0.0 for r in repos}
    spec = dict(cases=args.cases, repeat=args.repeat, inflight=args.inflight)
    for k in range(args.rounds):
        for i, repo in enumerate(repos):
            logs = os.path.join(args.logs, f"{i}_{os.path.basename(repo)}")
            os.makedirs(logs, exist_ok=True)
            log = os.path.join(logs, f"round_{k:02d}.log")
            if args.own:
                row = own_round(repo, env, log, spec, args.jobs, args.load)
            else:
                row = one_round(repo, env, log)
            row.update(round=k, repo=repo)
            print(json.dumps(row), flush=True)
            seconds[repo] += row["seconds"]
            if row["dead_rank"]:
                dead_rounds[repo].append(k)
            dead_jobs[repo] += row.get("dead_jobs", row["dead_rank"])
            clashes[repo] += row["port_clash"]
    summaries = [{"repo": repo, "rounds": args.rounds,
                  "dead_rounds": len(dead_rounds[repo]),
                  "which": dead_rounds[repo],
                  "dead_spawns": dead_jobs[repo],
                  "port_clash_rounds": clashes[repo],
                  **(dict(own=spec, jobs=args.jobs, load=args.load)
                     if args.own else
                     dict(workers=WORKERS, files=SPAWNING + LOAD)),
                  "debug_malloc": args.debug_malloc,
                  "backtrace": args.backtrace,
                  "seconds": round(seconds[repo], 1)} for repo in repos]
    for summary in summaries:
        print(json.dumps(summary), flush=True)
    return summaries


if __name__ == "__main__":
    main()
