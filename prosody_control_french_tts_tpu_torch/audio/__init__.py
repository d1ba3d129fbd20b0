"""Audio beyond the measure step: the two denoisers of the pipeline's
Preprocess (the quantile spectral gate and the MaskNet separator) and wav
concatenation."""
