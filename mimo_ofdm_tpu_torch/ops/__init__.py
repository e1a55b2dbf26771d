"""Numeric layer: bits, QAM, OFDM framing, PA models, noise and the fused
IFFT -> PA -> FFT chain."""
