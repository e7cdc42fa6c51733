"""Plain PyTorch ops of the port: front-end, VAD, DTW, spotting."""
