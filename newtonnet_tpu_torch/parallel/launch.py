'''Local multi-process launcher (the port's copy of the JAX package's
tools/launch_distributed.py).

Spawns N copies of a command, each with the NEWTONNET_DIST_{COORD,NPROCS,
PROCID} environment that parallel/distributed.maybe_initialize_from_env
reads (the coordinator at 127.0.0.1 on a free port), so the copies join
one torch.distributed process group: one process per rank, on the CPU
(gloo) or on the cards of this machine (NCCL with a card per rank, gloo
where ranks share one).

Example (two ranks of the training CLI, data parallel):

    python -m newtonnet_tpu_torch.parallel.launch --nprocs 2 -- \\
        python -m newtonnet_tpu_torch.train.cli --config config.yml

with `training: {parallel: {data: 2}}` in config.yml. Child stdout and
stderr go to <log-dir>/proc_{i}.log. The exit status is non-zero if any
child fails (its code), and the remaining children are then killed; 124
after --timeout.
'''
import argparse
import os
import signal
import socket
import subprocess
import sys
import time


def free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def run(cmd, nprocs, log_dir='.', timeout=None, env=None):
    '''Run `cmd` (a list) as `nprocs` ranks, each in `env` (default
    os.environ) with the three NEWTONNET_DIST_* variables; -> the exit
    status (0, the first failing child's code, or 124 on timeout).'''
    port = free_port()
    os.makedirs(log_dir, exist_ok=True)
    procs, logs = [], []
    for i in range(nprocs):
        log = open(os.path.join(log_dir, f'proc_{i}.log'), 'w')
        logs.append(log)
        child = dict(os.environ if env is None else env,
                     NEWTONNET_DIST_COORD=f'127.0.0.1:{port}',
                     NEWTONNET_DIST_NPROCS=str(nprocs),
                     NEWTONNET_DIST_PROCID=str(i))
        procs.append(subprocess.Popen(
            cmd, env=child, stdout=log, stderr=subprocess.STDOUT,
            start_new_session=True))
    print(f'launched {nprocs} processes (coordinator 127.0.0.1:{port}); '
          f'logs in {log_dir}/proc_*.log', file=sys.stderr)
    rc = 0
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [(i, c) for i, c in enumerate(codes)
                      if c is not None and c != 0]
            if failed:
                i, rc = failed[0]
                print(f'process {i} exited with {rc}', file=sys.stderr)
                break
            if all(c == 0 for c in codes):
                break
            if deadline is not None and time.monotonic() > deadline:
                print('timeout: killing the process set', file=sys.stderr)
                rc = 124
                break
            time.sleep(0.05)
    finally:
        for proc in procs:
            if proc.poll() is None:
                # the exact process group started here, never a pattern
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        for log in logs:
            log.close()
    return rc


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument('--nprocs', type=int, default=2)
    p.add_argument('--log-dir', default='.')
    p.add_argument('--timeout', type=float, default=None,
                   help='seconds before the whole set is killed')
    p.add_argument('cmd', nargs=argparse.REMAINDER,
                   help='command to run (prefix with --)')
    args = p.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd and args.cmd[0] == '--' else args.cmd
    if not cmd:
        p.error('no command given (append: -- python -m ...)')
    return run(cmd, args.nprocs, args.log_dir, args.timeout)


if __name__ == '__main__':
    sys.exit(main())
