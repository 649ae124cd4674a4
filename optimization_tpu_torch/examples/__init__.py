"""Runnable examples of the port (counterparts of ``examples/*.py``).

Each module is a short end-to-end use of a public entry point on synthetic
data, run as ``python -m optimization_tpu_torch.examples.<name>``: on the
card by default, on the CPU with ``--device cpu`` (without a card and
without that flag it raises).  Each has ``run(device, dtype=None,
data=None) -> dict`` (the numbers the JAX example prints; ``data``, a dict
of tensors, replaces the example's random draws) and ``main(argv=None)``,
which prints the JAX example's lines and applies its acceptance check.
"""

EXAMPLES = ("riemannian_optimization", "euclidean_optimization",
            "lobpcg_example", "lasso", "dtype_escalation",
            "rotation_sync_example", "certification_fleet",
            "online_warm_start", "staircase_escape",
            "matrix_completion_example", "pose_graph_g2o",
            "robust_pose_graph", "range_aided")
# the examples whose path runs LOBPCG (``lobpcg`` itself, ``spectral_init``,
# ``certify``): in f32 on the card each launches the ``gram_pair`` kernel;
# the others launch no kernel
LOBPCG_EXAMPLES = frozenset({
    "lobpcg_example", "rotation_sync_example", "certification_fleet",
    "online_warm_start", "staircase_escape", "pose_graph_g2o",
    "robust_pose_graph", "range_aided"})
