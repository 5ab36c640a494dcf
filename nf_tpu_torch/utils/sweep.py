"""Hyper-parameter sweep driver.

Counterpart of ``nf_tpu.utils.sweep``.  The reference runs its workers by
hand-spawning ``multiprocessing`` processes that push result tuples to a
shared queue (reference experiment_mg.py:85-87).  ``run_sweep`` keeps that
para-dict / queue-tuple contract in three modes:

  * ``"sequential"`` (default): one worker after another in this process;
  * ``"thread"``: a thread pool, for workers that release the GIL (the
    VEGAS baseline ``prov``, or workers on the card waiting for it);
  * ``"process"``: the reference's own mechanism, OS processes and a
    multiprocessing queue (spawn context).  Workers and their para values
    must pickle (module-level functions).

nf_tpu pins each process-mode child to JAX's CPU backend, because a TPU
cannot be shared across processes.  Several processes can share a CUDA
device, so the port pins nothing: each child runs on the device its para
names (``para["device"]``, the card by default).
"""

from __future__ import annotations

import queue

RESULT_FIELDS = (
    "best_loss", "unused", "best_loss_rel", "func_count", "varJ",
    "DKL", "best_var", "best_epoch", "method", "duration_s",
    "id", "sigma_pb", "sigma_err_pb", "final_variance",
)


def _process_entry(w, para, mp_queue):
    """Child entry point for mode="process": run the worker with the
    multiprocessing queue injected, the reference's contract
    (experiment_mg.py:85-87)."""
    para = dict(para)
    para["q"] = mp_queue
    w(para)


def _run_processes(jobs, limit):
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    mq = ctx.Queue()
    results = []

    def drain():
        while True:
            try:
                tup = mq.get_nowait()
            except queue.Empty:
                return
            results.append(dict(zip(RESULT_FIELDS, tup)))

    pending = list(jobs)
    running = []
    try:
        while pending or running:
            while pending and len(running) < limit:
                w, p = pending.pop(0)
                proc = ctx.Process(target=_process_entry, args=(w, p, mq))
                proc.start()
                running.append(proc)
            drain()
            still = []
            for proc in running:
                proc.join(timeout=0.2)
                if proc.exitcode is None:
                    still.append(proc)
                elif proc.exitcode != 0:
                    raise RuntimeError(f"sweep worker exited with code {proc.exitcode}")
            running = still
        drain()
    finally:
        # on failure, leak no child and lose no queued result: stop the
        # survivors, then drain what completed before the error
        for proc in running:
            if proc.is_alive():
                proc.terminate()
            proc.join()
        drain()
    return results


def run_sweep(paras, worker=None, workers=None, mode="sequential", max_workers=None):
    """Run workers over a list of para dicts; returns a list of result dicts.

    ``paras``: parameter dicts (reference experiment_mg.py:15-30 schema,
    minus ``q``, which is injected).  ``worker``: callable taking the para
    dict (default: the NIS worker ``pro``); ``para['worker']`` overrides it
    per para.  ``mode``: "sequential", "thread" or "process"
    (``max_workers`` bounds the pool; default = number of paras).  Results
    are decoded from the queue tuples into dicts keyed by RESULT_FIELDS, in
    completion order.  ``workers`` is accepted for nf_tpu's signature and
    unused, as there.
    """
    from nf_tpu_torch.utils.experiment import pro

    jobs = []
    for para in paras:
        p = {k: v for k, v in para.items() if k != "worker"}
        jobs.append((para.get("worker") or worker or pro, p))

    if mode == "process":
        return _run_processes(jobs, max_workers or len(jobs))

    q: queue.Queue = queue.Queue()
    for _, p in jobs:
        p["q"] = q
    if mode == "thread":
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=max_workers or len(jobs)) as ex:
            futures = [ex.submit(w, p) for w, p in jobs]
            for fut in futures:
                fut.result()  # propagate worker exceptions
    elif mode == "sequential":
        for w, p in jobs:
            w(p)
    else:
        raise ValueError(f"unknown sweep mode {mode!r}")

    results = []
    while not q.empty():
        results.append(dict(zip(RESULT_FIELDS, q.get_nowait())))
    return results
