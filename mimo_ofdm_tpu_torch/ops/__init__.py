"""Numeric layer: bits, QAM (hard and soft detection), OFDM framing, PA
models, noise, the fused IFFT -> PA -> FFT chain, and the coded link's
QC-LDPC / 5G-NR codecs and transport chain."""
