"""CMIGBench evaluation: CCS / TIS / FID and the four turn-wise accuracy
metrics (spatial, attribute, negative, numeracy), and the golden kit."""
