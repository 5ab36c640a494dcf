"""Experiment harness: the NIS sweep worker and the VEGAS baseline worker.

Counterpart of ``nf_tpu.utils.experiment``: the reference's multiprocessing
workers (reference utils/experiment_mg.py:12-123 ``pro`` and
utils/experiment_mgv.py:11-82 ``prov``).  The parameter dict keys, the
14-tuple pushed to ``para["q"]`` and the ``log.txt`` contents are the
reference's, so downstream sweep scripts keep working.

The workers run on the card unless ``para["device"]`` names another device
(``"cpu"``); the reference's ``"dev"`` key is accepted and ignored.  The
integrand ``para["f"]`` maps a tensor ``[B, n_flow]`` to ``[B]``.
"""

from __future__ import annotations

import datetime
import os
import pprint

from nf_tpu_torch.training import manager, optimizers

GEV2_TO_PB = 2.56819e-9   # reference experiment_mg.py:62
EPOCH_LENGTH = 800        # reference experiment_mg.py:10


def pro(para):
    """NIS worker: train a PWQuad flow on ``para['f']`` and push the
    14-tuple result (tagged "NIS") to ``para['q']``."""
    n_flow = para["n_flow"]
    n_bins = para["n_bins"]
    NN_width = para["NN_width"]
    NN_length = para["NN_length"]
    lr = para["lr"]
    wd = para["weight_decay"]
    var_n = para["var_n"]
    batch_size = para["batch_size"]
    pt = para["pt"]
    q = para["q"]
    internal_id = para["id"]
    f = para["f"]
    logdir = para["logdir"] + "/" + str(internal_id)
    log = para["log"]
    seed = para.get("seed", 0)
    device = para.get("device", "cuda")
    # optional nf_tpu extensions (absent keys keep reference behavior,
    # reference experiment_mg.py:15-30 schema)
    epochs = para.get("epochs", EPOCH_LENGTH)
    loss_mode = para.get("loss_mode", "var")
    select_best_by = para.get("select_best_by", "loss")
    kill_counter = para.get("kill_counter", 7)

    start_time = datetime.datetime.now(datetime.timezone.utc)
    os.makedirs(logdir, exist_ok=True)
    with open(os.path.join(logdir, "log.txt"), "w+") as file:
        file.write("Started \n")
        file.write(f"Batchsize: {batch_size} n_bins: {n_bins} "
                   f"NN_length: {NN_length} NN_width: {NN_width}\n")
        file.write(f"LR: {lr} weight decay: {wd} preburn_time: {pt}\n")
        file.write("-----------\n")

        NF = manager.PWQuadManager(n_flow=n_flow, seed=seed, device=device)
        file.write("Create Model \n")
        NF.create_model(n_cells=2, n_bins=n_bins, NN=[NN_width] * NN_length)
        file.write("Model Created \n")
        optim = optimizers.adamax(lr, wd)
        file.write("Start training \n")

        sig, sig_err = NF._train_variance_forward_seq(
            f, optim, log, logdir, batch_size, epochs,
            pretty_progressbar=False, save_best=True, run=None,
            integrate=True, mini_batch_size=batch_size, preburn_time=pt,
            kill_counter=kill_counter, loss_mode=loss_mode,
            select_best_by=select_best_by)

        file.write("End training \n")
        end_time = datetime.datetime.now(datetime.timezone.utc)
        file.write("{0:5E}  +/- {1:3E}  \n".format(sig, sig_err))
        sig = sig / GEV2_TO_PB
        sig_err = sig_err / GEV2_TO_PB

        # fresh-sample diagnostics (reference experiment_mg.py:66-76), moved to
        # the host once
        x, jacv = NF.sample(int(var_n))
        fw = (f(x) * jacv).cpu().numpy()
        v_var = float(fw.var(ddof=1))
        w_max = float(fw.max())
        w_mean = float(fw.mean())

        q.put((NF.best_loss, None, NF.best_loss_rel, NF.best_func_count, NF.varJ,
               NF.DKL, NF.best_var, NF.best_epoch, "NIS",
               (end_time - start_time).total_seconds(), internal_id, sig,
               sig_err, v_var))

        file.write("Final Variance: {0:5E} \n".format(v_var))
        file.write("{0:5E}  +/- {1:3E} pb \n".format(sig, sig_err))
        sig2, sig_err2 = NF.integrate(f, 10, int(var_n))
        file.write("Post training integrate:\n")
        file.write("{0:5E}  +/- {1:3E} pb \n".format(
            sig2 / GEV2_TO_PB, sig_err2 / GEV2_TO_PB))
        file.write("Unweighting efficiency: " + str(w_mean / w_max) + "\n")
        file.write("Duration:\n")
        file.write(str((end_time - start_time).total_seconds()) + "\n")
        file.write("-----------\n")
        file.write("Initial loss\n" + str(NF.int_loss) + "\n")
        file.write("Best loss\n" + str(NF.best_loss) + "\n")
        file.write("Best loss relative\n" + str(NF.best_loss_rel) + "\n")
        file.write("Evaluations\n" + str(NF.best_func_count) + "\n")
        file.write("Epoch\n" + str(NF.best_epoch) + "\n")
        file.write("---------------\n")
        file.write(pprint.pformat({k: v for k, v in para.items()
                                   if k not in ("q", "f")}))


def prov(para):
    """VEGAS baseline worker (reference experiment_mgv.py:11-82): the same
    queue tuple, tagged "VEGAS", for an apples-to-apples comparison."""
    from nf_tpu_torch.training.vegas import VegasIntegrator

    n_flow = para["n_flow"]
    var_n = para["var_n"]
    q = para["q"]
    internal_id = para["id"]
    f = para["f"]
    logdir = para["logdir"] + "/" + str(internal_id)
    seed = para.get("seed", 0)
    device = para.get("device", "cuda")
    neval, nitn = 5000, 30   # reference experiment_mgv.py:8-9

    os.makedirs(logdir, exist_ok=True)
    with open(os.path.join(logdir, "log.txt"), "w+") as fh:
        fh.write(f"{nitn} iterations with {neval} evaluations \n")
        start_time = datetime.datetime.now(datetime.timezone.utc)

        integ = VegasIntegrator(n_flow, n_bins=50, seed=seed, device=device)
        result_mean, result_sdev = integ.run(f, nitn=nitn, neval=neval)
        sig = result_mean / GEV2_TO_PB
        sig_err = result_sdev / GEV2_TO_PB

        # fresh-sample diagnostics through the adapted map, moved to the host once
        x, jac = integ.sample(int(var_n))
        f2 = (f(x) * jac).cpu().numpy()
        v_var = float(f2.var())
        w_max = float(f2.max())
        w_mean = float(f2.mean())

        fh.write("RESULT \n")
        fh.write("{0:5E}  +/- {1:3E}  \n".format(result_mean, result_sdev))
        fh.write("{0:5E}  +/- {1:3E} pb \n".format(sig, sig_err))
        fh.write("Final Variance: " + str(v_var) + "\n")
        fh.write("Unweighting efficiency: " + str(w_mean / w_max) + "\n")
        end_time = datetime.datetime.now(datetime.timezone.utc)
        fh.write("Duration: \n")
        fh.write(str((end_time - start_time).total_seconds()) + "\n")
        fh.write("-----\n")

        q.put((0, None, 0, (nitn + 5) * neval, 0,
               0, 0, 0, "VEGAS", (end_time - start_time).total_seconds(),
               internal_id, sig, sig_err, v_var))
        fh.write(pprint.pformat({k: v for k, v in para.items()
                                 if k not in ("q", "f")}))
