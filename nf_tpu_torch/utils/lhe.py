"""Les Houches Event (LHE) file writer/reader.

Counterpart of ``nf_tpu.utils.lhe``: the standard interchange format (Les
Houches Accord, Alwall et al., hep-ph/0609017; ``<LesHouchesEvents>``
version 3.0) written from the arrays the unweighters return
(``multichannel_unweight``, ``generate_unweighted``), so the events plug
into Pythia/Herwig-class tools.  The same text as nf_tpu's for the same
arrays and arguments.

Conventions
-----------
* Input momenta are ``[N, P, 4]`` with components (E, px, py, pz), rows 0
  and 1 the incoming partons when ``xb`` is given (COM frame; the writer
  boosts to the lab frame with
  :func:`nf_tpu_torch.phasespace.lorentz.boost_to_lab_frame` in float64).
  Without ``xb`` every row is written as outgoing (status +1) in the given
  frame.
* LHE ``PUP`` columns are (px, py, pz, E, m); masses are recomputed from
  the 4-vectors (clipped at 0 for roundoff).
* ``weights=None`` writes unit-weight events (IDWTUP=3); an array (e.g.
  partial unweighting's ``max(1, w/w_max)`` carried weights) writes
  weighted events (IDWTUP=4, XWGTUP = weight * unit_weight_pb).
* Color flow: colorless rows get (0,0); a q-qbar (or qbar-q) initial
  state gets the single color line (501,0)/(0,501).  Anything else is
  given through ``colors`` ([P, 2] ints).

The reader exists for round trips and light analysis: it reads what the
writer emits (one <init> block and homogeneous <event> blocks).
"""

from __future__ import annotations

import io
import os
import xml.etree.ElementTree as ET

import numpy as np
import torch

from nf_tpu_torch.phasespace import lorentz


def _masses(p):
    """Invariant mass per particle from (E, px, py, pz); roundoff-clipped."""
    m2 = p[..., 0] ** 2 - (p[..., 1:] ** 2).sum(-1)
    return np.sqrt(np.clip(m2, 0.0, None))


def write_lhe(path, momenta, pdgs, *, weights=None, xb=None,
              beam_pdgs=(2212, 2212), E_beam=6500.0, sigma_pb=None,
              sigma_err_pb=None, unit_weight_pb=None, process_id=1,
              scale=None, alpha_qed=-1.0, alpha_qcd=-1.0, colors=None,
              generator="nf_tpu_torch"):
    """Write events to ``path`` (or a file-like object) in LHE 3.0.

    Parameters
    ----------
    momenta : [N, P, 4] (E, px, py, pz).  With ``xb``: COM frame, rows
        0/1 the incoming partons (boosted to lab and written status -1).
        Without ``xb``: all rows outgoing, written as they are.
    pdgs : length-P PDG codes for every row (incoming included).
    weights : optional [N] event weights; ``None`` = unit-weight events.
    xb : optional [N, 2] Bjorken fractions (enables the lab boost and the
        incoming/outgoing status split).
    sigma_pb / sigma_err_pb : cross section for the <init> block (pb, the
        LHE unit).  ``unit_weight_pb`` defaults to sigma_pb.
    scale : factorization scale per event ([N] or scalar, GeV); defaults
        to sqrt(s_hat) of the incoming pair when ``xb`` is given, else -1.
    colors : optional [P, 2] color/anticolor tags overriding the default.
    generator : the name written in the file's comment.
    """
    momenta = np.asarray(momenta, np.float64)
    n, n_tot = momenta.shape[0], momenta.shape[1]
    pdgs = [int(v) for v in pdgs]
    assert len(pdgs) == n_tot, (len(pdgs), n_tot)

    if xb is not None:
        xb = np.asarray(xb, np.float64)
        full = lorentz.boost_to_lab_frame(
            torch.from_numpy(momenta), torch.from_numpy(xb[:, 0].copy()),
            torch.from_numpy(xb[:, 1].copy())).numpy()
        n_in = 2
        if scale is None:
            s_hat = ((full[:, 0] + full[:, 1])[:, 0] ** 2
                     - ((full[:, 0] + full[:, 1])[:, 1:] ** 2).sum(-1))
            scale = np.sqrt(np.clip(s_hat, 0.0, None))
    else:
        full, n_in = momenta, 0
        if scale is None:
            scale = -1.0
    statuses = [-1] * n_in + [1] * (n_tot - n_in)
    mothers = [(0, 0)] * n_in + [(1, 2) if n_in else (0, 0)] * (n_tot - n_in)
    scale = np.broadcast_to(np.asarray(scale, np.float64), (n,))

    if colors is None:
        colors = [(0, 0)] * n_tot
        if n_in == 2:
            a, b = pdgs[0], pdgs[1]
            if 0 < a < 7 and b == -a:        # q qbar -> colorless
                colors[0], colors[1] = (501, 0), (0, 501)
            elif -7 < a < 0 and b == -a:     # qbar q -> colorless
                colors[0], colors[1] = (0, 501), (501, 0)
    colors = [tuple(int(v) for v in c) for c in colors]
    assert len(colors) == n_tot

    uw = unit_weight_pb if unit_weight_pb is not None \
        else (float(sigma_pb) if sigma_pb is not None else 1.0)
    if weights is None:
        # IDWTUP=3: unweighted events, XWGTUP = +1 exactly (the shower
        # normalizes with XSECUP); XMAXUP column carries the unit weight
        idwtup, xwgt = 3, np.ones(n)
    else:
        # IDWTUP=4: weighted events, average XWGTUP = sigma in pb
        idwtup, xwgt = 4, np.asarray(weights, np.float64) * uw
    sig = float(sigma_pb) if sigma_pb is not None else 1.0
    sig_err = float(sigma_err_pb) if sigma_err_pb is not None else 0.0

    masses = _masses(full)
    close = False
    if isinstance(path, (str, bytes, os.PathLike)):
        fh, close = open(path, "w"), True
    else:
        fh = path
    try:
        fh.write('<LesHouchesEvents version="3.0">\n')
        fh.write(f"<!--\nFile generated by {generator}\n-->\n")
        fh.write("<header>\n</header>\n")
        fh.write("<init>\n")
        fh.write(f"{beam_pdgs[0]:d} {beam_pdgs[1]:d} "
                 f"{E_beam:.10e} {E_beam:.10e} 0 0 0 0 {idwtup:d} 1\n")
        fh.write(f"{sig:.10e} {sig_err:.10e} {uw:.10e} {process_id:d}\n")
        fh.write("</init>\n")
        for i in range(n):
            fh.write("<event>\n")
            fh.write(f"{n_tot:d} {process_id:d} {xwgt[i]:.10e} "
                     f"{scale[i]:.10e} {alpha_qed:.10e} {alpha_qcd:.10e}\n")
            for j in range(n_tot):
                p = full[i, j]
                fh.write(
                    f"{pdgs[j]:d} {statuses[j]:d} "
                    f"{mothers[j][0]:d} {mothers[j][1]:d} "
                    f"{colors[j][0]:d} {colors[j][1]:d} "
                    f"{p[1]:+.10e} {p[2]:+.10e} {p[3]:+.10e} "
                    f"{p[0]:+.10e} {masses[i, j]:+.10e} 0.0000e+00 9.\n")
            fh.write("</event>\n")
        fh.write("</LesHouchesEvents>\n")
    finally:
        if close:
            fh.close()


def read_lhe(path):
    """Parse an LHE file (as written by :func:`write_lhe`).

    Returns a dict: ``init`` (beam pdgs/energies, idwtup, sigma, err,
    unit weight, process id), ``pdgs`` [P], ``status`` [P], ``colors``
    [P, 2] (from the first event), ``momenta`` [N, P, 4]
    (E, px, py, pz), ``masses`` [N, P], ``weights`` [N], ``scales`` [N].
    """
    root = ET.parse(path).getroot()
    init_lines = root.find("init").text.strip().splitlines()
    b = init_lines[0].split()
    p = init_lines[1].split()
    init = {"beam_pdgs": (int(b[0]), int(b[1])),
            "E_beams": (float(b[2]), float(b[3])),
            "idwtup": int(b[8]), "n_processes": int(b[9]),
            "sigma_pb": float(p[0]), "sigma_err_pb": float(p[1]),
            "unit_weight_pb": float(p[2]), "process_id": int(p[3])}
    momenta, masses, weights, scales = [], [], [], []
    pdgs, status, colors = None, None, None
    for ev in root.findall("event"):
        lines = ev.text.strip().splitlines()
        head = lines[0].split()
        n_tot = int(head[0])
        weights.append(float(head[2]))
        scales.append(float(head[3]))
        rows = [ln.split() for ln in lines[1:1 + n_tot]]
        if pdgs is None:
            pdgs = [int(r[0]) for r in rows]
            status = [int(r[1]) for r in rows]
            colors = [(int(r[4]), int(r[5])) for r in rows]
        momenta.append([[float(r[9]), float(r[6]), float(r[7]),
                         float(r[8])] for r in rows])
        masses.append([float(r[10]) for r in rows])
    return {"init": init, "pdgs": np.asarray(pdgs),
            "status": np.asarray(status), "colors": np.asarray(colors),
            "momenta": np.asarray(momenta), "masses": np.asarray(masses),
            "weights": np.asarray(weights), "scales": np.asarray(scales)}


def lhe_string(momenta, pdgs, **kw):
    """:func:`write_lhe` into a string (tests, small files)."""
    buf = io.StringIO()
    write_lhe(buf, momenta, pdgs, **kw)
    return buf.getvalue()
