"""The sharded candidate search over ``torch.distributed`` (``mesh.py``) and
the collectives it issues (``collectives.py``).  Importing the package
imports neither: ``collectives`` is reached from the optimizer layer,
``mesh`` from the callers of the sharded drivers."""
