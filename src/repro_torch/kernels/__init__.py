"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

=================  ===================================  =========================================
kernel             source                               replaces (TPU kernel)
=================  ===================================  =========================================
fourier_sketch     ``csrc/fourier_sketch.cu``           ``repro/kernels/fourier_sketch.py``
                                                        ``fourier_sketch_kernel``
assign_argmin      ``csrc/assign_argmin.cu``            ``repro/kernels/assign_argmin.py``
                                                        ``assign_argmin_kernel``
=================  ===================================  =========================================

``kernels.ops`` dispatches on the tensor's device; ``kernels._build`` compiles
the sources with nvcc on first use and loads them with ctypes.
"""
