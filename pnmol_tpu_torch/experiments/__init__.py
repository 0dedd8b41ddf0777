"""The paper's figure drivers on the port (counterparts of
``experiments/figure{1,2,3,4}.py``, ``common.py`` and ``plotting.py``).

Each driver runs as ``python -m pnmol_tpu_torch.experiments.figureN
[--fast] [--no-plot] [--device cuda|cpu] [--out DIR]`` and exposes
``run(device, *, fast=False, ...)``, which returns its arrays under the
JAX drivers' names. matplotlib is imported only by :mod:`plotting`, and
only when a figure is rendered.
"""
