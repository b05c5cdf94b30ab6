"""PyTorch/CUDA port of the cooperative-minibatching GNN system.

The package mirrors ``repro``'s layout module for module (``core``,
``data``, ``engine``, ``kernels``, ``models``, ``store``, ``serve``,
``train``, ``utils``) and imports neither JAX nor ``repro``: the JAX package is the
reference it is tested against.  Entry points run on CUDA unless
``device="cpu"`` is passed; the TPU kernels on the serving and training
paths are hand-written CUDA kernels for Hopper (``sm_90a``), built at
first use.
"""
