"""host_syncs_per_solve (count): blocking host reads a solve, the warnings
``torch.cuda.set_sync_debug_mode("warn")`` raises over the mix's
``sync_solves`` solves run after the traced window (so the warnings do not
slow it), over their number."""


def read(run):
    return run.syncs_per_solve
