"""The compressive K-means pipeline: frequencies, operators, sketch engine,
decoders and the Lloyd-Max baseline (counterpart of ``repro.core``)."""
