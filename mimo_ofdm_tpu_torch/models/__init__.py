"""System layer: geometry, channels, precoding, TX chain, CNC/MCNC receivers
and the Monte-Carlo link frame."""
