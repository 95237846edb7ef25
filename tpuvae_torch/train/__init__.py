"""Training-side helpers the serving slice needs (counterpart of ``tpuvae.train``)."""
