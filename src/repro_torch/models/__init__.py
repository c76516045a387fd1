"""The model stack: config, layers, the SSD mixer and the decoder stack."""
