"""Plain PyTorch ops of the port: front-end, VAD, DTW, spotting, HMM
Viterbi, connected-word level building and grammars."""
