"""The port's kernel plane: hand-written CUDA kernels for sm_90a (``csrc/``),
their wrappers with plain PyTorch versions beside them (``ref``), and the
engine's entry points (``dispatch``).  ``build`` compiles and loads the
library at first use."""
