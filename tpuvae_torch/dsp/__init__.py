"""Batched feature extraction on torch tensors (counterpart of ``tpuvae.dsp``)."""
