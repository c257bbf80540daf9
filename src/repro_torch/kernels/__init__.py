"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

===========================  =====================================  ==============================================
kernel                       source                                 replaces (TPU kernel)
===========================  =====================================  ==============================================
fourier_sketch               ``csrc/fourier_sketch.cu``             ``repro/kernels/fourier_sketch.py``
                                                                    ``fourier_sketch_kernel``
assign_argmin                ``csrc/assign_argmin.cu``              ``repro/kernels/assign_argmin.py``
                                                                    ``assign_argmin_kernel``
quantized_fourier_sketch     ``csrc/quantized_fourier_sketch.cu``   ``repro/kernels/fourier_sketch.py``
                                                                    ``quantized_fourier_sketch_kernel``
structured_sketch            ``csrc/structured_sketch.cu``          ``repro/kernels/freq_transform.py``
                                                                    ``structured_sketch_kernel``
quantized_structured_sketch  ``csrc/structured_sketch.cu``          ``repro/kernels/freq_transform.py``
                                                                    ``quantized_structured_sketch_kernel``
sketch_shift                 ``csrc/sketch_shift.cu``               ``repro/kernels/sketch_shift.py``
                                                                    ``sketch_shift_kernel``
amp_denoise                  ``csrc/amp_denoise.cu``                ``repro/kernels/amp_denoise.py``
                                                                    ``amp_denoise_kernel``
flash_attention              ``csrc/flash_attention.cu``            ``repro/kernels/flash_attention.py``
                                                                    ``flash_attention_kernel``
===========================  =====================================  ==============================================

The Python wrappers live in ``fourier_sketch.py`` (the first and third),
``assign_argmin.py``, ``freq_transform.py`` (the fourth and fifth),
``sketch_shift.py``, ``amp_denoise.py`` and ``flash_attention.py``.
``kernels.ops`` dispatches on the tensor's device and the operator's family;
``kernels._build`` compiles the sources with nvcc on first use and loads them
with ctypes; ``kernels._launch`` holds the wrappers' device checks, the card's SM count
and current stream, and the grid sizing.
"""
