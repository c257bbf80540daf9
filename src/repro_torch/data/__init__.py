"""Datasets for the port (counterpart of ``repro.data``)."""
