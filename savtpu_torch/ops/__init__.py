"""Element core and kernels: quadrature, shape functions, material,
batched element integrals, assembly, and the online banded kernel."""
