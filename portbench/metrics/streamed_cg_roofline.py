"""streamed_cg_roofline (%): the least time the card could take for the
window's trust-region subproblems, over the streamed CG kernel's device
time (``torch.profiler``; kernels matched by the names the system under
test states, ``run.kernels``).

The least time is the larger of bytes / 3.35 TB/s and operations / 67
TFLOP/s f32 (``peaks.py``), summed over every subproblem of the window at
its own CG count k.  It counts the work of the Steihaug-Toint recurrence on
the sphere Hessian (A0 diagonal, generated, plus the rank-2 term in x), not
any kernel's design:

- once a subproblem: g read, the step s written (2 n words);
- each CG iteration, per element: r and p read and written (4 words), x
  read (1), s read and written every second iteration (1 on average: a pass
  holds p_{k-1} and p_k together, so two steps fold into one update; a
  longer deferral costs as much in extra reads of earlier p as it saves),
  so 6 n words before anything stays on the chip;
- less what the chip could hold between iterations: the L2, every SM's
  shared memory and register file (their sizes read from the device),
  filled first with r and p (each held byte saves 2 words an iteration),
  then with x or s (1);
- 19 f32 operations an element an iteration (p = -r + beta p; q = A0 p + U c;
  <p, q>; r += alpha q; <r, r>; the two dots of U' with a carried vector;
  s += alpha p), none for the generated diagonal or preconditioner.

So no design, however much it keeps on the chip, can read above 100%.
"""

WORD = 4                       # f32 storage
OPS_PER_ELEMENT = 19
CONVERGED = (1, 2)             # TNTStatus GRADIENT, PRECONDITIONED_GRADIENT


def iteration_bytes(n: int, on_chip: int) -> int:
    """Bytes one CG iteration must move at size n with ``on_chip`` bytes
    held between iterations."""
    vec = n * WORD
    held_rp = min(on_chip, 2 * vec)
    held_xs = min(max(on_chip - 2 * vec, 0), 2 * vec)
    return 6 * vec - 2 * held_rp - held_xs


def subproblem_work(n: int, k: int, on_chip: int):
    """(bytes, f32 operations) of one subproblem of k CG iterations."""
    return (2 * n * WORD + k * iteration_bytes(n, on_chip),
            k * OPS_PER_ELEMENT * n)


def least_seconds(n: int, iterations, card) -> float:
    """Least time of the subproblems with CG counts ``iterations``."""
    total_b = total_ops = 0
    for k in iterations:
        b, ops = subproblem_work(n, k, card.on_chip_bytes)
        total_b += b
        total_ops += ops
    return max(total_b / card.hbm_bytes_per_s,
               total_ops / card.f32_flops_per_s)


def subproblems(solve) -> list:
    """CG counts of the subproblems a solve ran: one an outer iteration,
    but for the last when the solve stopped on its gradient test."""
    inner = solve["inner"]
    return inner[:-1] if solve["status"] in CONVERGED else inner


def read(run):
    if run.trace is None or run.card is None:
        return None
    kernel_s = run.trace.device_time_s(
        lambda name: any(k in name for k in run.kernels))
    its = [k for s in run.solves for k in subproblems(s)]
    if kernel_s <= 0 or not its:
        return None
    return 100.0 * least_seconds(run.mix["n"], its, run.card) / kernel_s
