"""Lyrics embedding (counterpart of ``tpuvae/text``; hashed n-grams only)."""
