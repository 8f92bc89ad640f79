"""The benchmark of ``relp_tpu_torch``, the PyTorch and CUDA port: one run of
one cell by ``python3 -m portbench.run`` (see ``portbench/run.py``).

It imports neither JAX nor the JAX package.  The plain reference under
``portbench/reference`` and the generators under ``portbench/gen`` import
nothing of the program either; a problem under ``portbench/problems``
reaches the program only to build the model it is given.
"""
