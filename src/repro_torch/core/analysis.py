"""Closed-form I/O / time models transcribed from the thesis.

The PyTorch port's own copy of the JAX package's ``core/analysis.py`` (the
port imports nothing of that package).  Each function is a direct
transcription of a lemma/theorem so the executable simulation
(``repro_torch.core``) can be validated *exactly* against the paper:

* Lemma 2.2.1 / Thm 2.2.2 / Thm 2.2.3  — PEMS1 single-processor Alltoallv
* Lemma 7.1.3 / Cor 7.1.4 / Thm 7.1.6  — PEMS2 EM-Alltoallv-Seq
* Lemma 7.1.8 / Thm 7.1.10             — PEMS2 EM-Alltoallv-Par
* Lemma 7.2.1 / Thm 7.2.3              — EM-Bcast
* Lemma 7.3.1 / Thm 7.3.3              — EM-Gather
* Lemma 7.4.2 / Thm 7.4.4              — EM-Reduce
* §6.3 / Fig 6.2                       — disk-space requirements

All byte quantities share one unit (bytes); time models are parameterised by
the EM-BSP coefficients (Appendix B.4): S, G (seconds per block of size B),
g, l (BSP* network), L (virtual superstep overhead).

Known thesis inconsistency: Lemma 7.1.8 with
``P = 1`` does **not** reduce to Lemma 7.1.3 because the parallel analysis
counts all ``v²/P`` network-received deliveries even when every destination is
local.  The event-level simulation in :mod:`repro_torch.core.collectives`
resolves the local/remote split exactly; tests check it against Lemma 7.1.3
at ``P = 1`` and against :func:`pems2_alltoallv_par_io_exact` for ``P > 1``.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class MachineModel:
    """EM-BSP system parameters (thesis Appendix B.4)."""

    B: int = 4096            # disk block size, bytes
    D: int = 1               # disks per real processor
    S: float = 1.0           # time per swapped block
    G: float = 1.0           # time per delivered block
    g: float = 0.0           # time per network packet of size b
    b: int = 4096            # minimum network message for rated throughput
    l: float = 0.0           # network superstep overhead
    L: float = 0.0           # virtual superstep overhead


# --------------------------------------------------------------------------- #
# PEMS1 Alltoallv (baseline), thesis §2.2                                      #
# --------------------------------------------------------------------------- #

def pems1_alltoallv_io(v: int, mu: int, omega: int) -> int:
    """Lemma 2.2.1: total I/O volume of SIMPLE-ALLTOALLV-SEQ."""
    return 4 * v * mu + 2 * v * v * omega


def pems1_alltoallv_time(v: int, mu: int, omega: int, m: MachineModel) -> float:
    """Thm 2.2.2: S·4vμ/B + G·2v²⌈ω⌉/B + 2L."""
    om = round_up(omega, m.B)
    return m.S * 4 * v * mu / m.B + m.G * 2 * v * v * om / m.B + 2 * m.L


def pems1_alltoallv_disk(v: int, P: int, mu: int, omega: int) -> int:
    """Thm 2.2.3 / §6.3: per-real-processor disk: vμ/P contexts + v²ω indirect
    area sized for all incoming messages (the indirect area scales with v)."""
    return v * mu // P + v * v * omega


# --------------------------------------------------------------------------- #
# PEMS2 EM-Alltoallv, thesis §7.1                                              #
# --------------------------------------------------------------------------- #

def alltoallv_delta_seq(v: int, k: int) -> int:
    """δ of Lemma 7.1.3: messages deliverable directly, ID-ordered rounds."""
    assert v % k == 0
    return (v * v + v * k) // 2


def pems2_alltoallv_seq_io(v: int, k: int, mu: int, omega: int, B: int) -> int:
    """Lemma 7.1.3: vμ + ((v²−vk)/2)·ω + 2v²B."""
    return v * mu + ((v * v - v * k) * omega) // 2 + 2 * v * v * B


def pems2_alltoallv_seq_improvement(
    v: int, k: int, mu: int, omega: int, B: int
) -> int:
    """Cor 7.1.4: 2vμ + ((3v²+vk)/2)·ω − 2v²B less I/O than PEMS1."""
    return 2 * v * mu + ((3 * v * v + v * k) * omega) // 2 - 2 * v * v * B


def pems2_alltoallv_seq_buffer(v: int, P: int, B: int) -> int:
    """Lemma 7.1.5: boundary-block cache ≤ 2v²B/P."""
    return 2 * v * v * B // P


def pems2_alltoallv_seq_time(
    v: int, k: int, mu: int, omega: int, m: MachineModel
) -> float:
    """Thm 7.1.6: S·vμ/BD + G·(v²−vk)ω/2BD + G·2v²/D + L."""
    return (
        m.S * v * mu / (m.B * m.D)
        + m.G * (v * v - v * k) * omega / (2 * m.B * m.D)
        + m.G * 2 * v * v / m.D
        + m.L
    )


def pems2_alltoallv_par_io_thesis(
    v: int, P: int, k: int, mu: int, omega: int, B: int
) -> float:
    """Lemma 7.1.8 as printed: vμ/P + (v²/P + 3v²/2P² − kv/2P − v²)ω + 2v²B."""
    return (
        v * mu / P
        + (v * v / P + 3 * v * v / (2 * P * P) - k * v / (2 * P) - v * v) * omega
        + 2 * v * v * B
    )


def pems2_alltoallv_par_io_exact(
    v: int, P: int, k: int, mu: int, omega: int, B: int
) -> int:
    """Event-exact global I/O of EM-Alltoallv-Par with the local/remote split.

    Per real processor, m = v/P local VPs:
      * swap out all contexts minus the v receive slots:    m·(μ − v·ω)
      * local deliveries: δ direct (ω) + (m² − δ) late (2ω) with
        δ = (m² + mk)/2  (ID-ordered rounds of k, Lemma 7.1.3 structure)
      * network-received messages delivered to disk:        m·(v − m)·ω
      * boundary-block flush (2v blocks per local VP):      2·m·v·B
    """
    m = v // P
    delta = (m * m + m * k) // 2
    per_proc = (
        m * (mu - v * omega)
        + delta * omega
        + 2 * (m * m - delta) * omega
        + m * (v - m) * omega
        + 2 * m * v * B
    )
    return per_proc * P


def pems2_alltoallv_par_buffer(v: int, P: int, k: int, alpha: int, omega: int,
                               B: int) -> int:
    """Lemma 7.1.9: 2v²B/P + αkω."""
    return 2 * v * v * B // P + alpha * k * omega


def pems2_alltoallv_par_comm_time(
    v: int, P: int, k: int, alpha: int, omega: int, m: MachineModel
) -> float:
    """Lemma 7.1.7: g·αkω/b + l·v²/(Pkα)."""
    return m.g * alpha * k * omega / m.b + m.l * v * v / (P * k * alpha)


def pems2_alltoallv_par_network_rounds(v: int, P: int, k: int,
                                       alpha) -> int:
    """Bulk all-to-all launches of the network phase.  Unchunked
    (``alpha=None``): a single launch.  α-chunked (Alg 7.1.3): the m = v/P
    local contexts proceed in source rounds of k, each shipping its
    destinations in ⌈m/α⌉ α-chunks — one launch per (round, chunk), moving
    ≤ α·k·ω words per (source, destination) process pair (Lemma 7.1.9's
    buffer bound).  Lemma 7.1.7's ``l`` term counts v²/(Pkα) = P· the
    chunked count in *point-to-point* rounds; a bulk all-to-all serves all
    P destinations at once."""
    if alpha is None:
        return 1
    m = v // P
    return (m // k) * -(-m // alpha)


def pems2_disk_space(v: int, P: int, mu: int) -> int:
    """§6.3: PEMS2 needs exactly vμ/P per real processor (no indirect area)."""
    return v * mu // P


# --------------------------------------------------------------------------- #
# Rooted collectives, thesis §7.2–7.4                                          #
# --------------------------------------------------------------------------- #

def em_bcast_io(v: int, P: int, k: int, mu: int, omega: int) -> int:
    """Lemma 7.2.1 worst case: swap 2vμ/(Pk) (root-partition sharers swap out
    and back in) + every VP delivers the ω payload to its context."""
    return 2 * v * mu // (P * k) + v * omega


def em_bcast_time(v: int, P: int, k: int, mu: int, omega: int,
                  m: MachineModel) -> float:
    """Thm 7.2.3: S·2vμ/PkB + G·vω/PDB + g·ω/b + l + L."""
    return (
        m.S * 2 * v * mu / (P * k * m.B)
        + m.G * v * omega / (P * m.D * m.B)
        + m.g * omega / m.b
        + m.l
        + m.L
    )


def em_gather_io(mu: int, omega: int) -> int:
    """Lemma 7.3.1 worst case: the root may swap out (μ) and deliver vω... the
    thesis bound is μ + ω (root swap + result write at block granularity)."""
    return mu + omega


def em_gather_time(v: int, P: int, mu: int, omega: int, m: MachineModel) -> float:
    """Thm 7.3.3: S·(μ+ω)/BD + g·vω/(Pb) + l·v/P + L."""
    return (
        m.S * (mu + omega) / (m.B * m.D)
        + m.g * v * omega / (P * m.b)
        + m.l * v / P
        + m.L
    )


def em_reduce_io(n: int, omega: int) -> int:
    """Lemma 7.4.2: the root delivers the n·ω result to its context."""
    return n * omega


def em_reduce_time(v: int, P: int, k: int, n: int, omega: int,
                   m: MachineModel) -> float:
    """Thm 7.4.4: G·nω/B + g·nω·lgP/b + l·lgP + n·lgP + nv/(Pk) + nk + L."""
    lgP = math.log2(P) if P > 1 else 0.0
    return (
        m.G * n * omega / m.B
        + m.g * n * omega * lgP / m.b
        + m.l * lgP
        + n * lgP
        + n * v / (P * k)
        + n * k
        + m.L
    )


# --------------------------------------------------------------------------- #
# Fig 6.2 — disk-space table                                                   #
# --------------------------------------------------------------------------- #

def disk_space_table(v_per_p: int, mu: int, procs: tuple = (1, 2, 4, 8, 16)):
    """Reproduces Fig 6.2 rows: (P, v, required, PEMS1/proc, PEMS1 total,
    PEMS2/proc, PEMS2 total), all in bytes."""
    rows = []
    for P in procs:
        v = v_per_p * P
        required = v * mu
        pems1_per = v_per_p * mu + v * mu  # contexts + indirect area (scales v)
        pems2_per = v_per_p * mu
        rows.append((P, v, required, pems1_per, pems1_per * P, pems2_per,
                     pems2_per * P))
    return rows


def round_up(x: int, b: int) -> int:
    return -(-x // b) * b


def round_down(x: int, b: int) -> int:
    return (x // b) * b
