"""The frozen yardstick: the card's published peaks, the FLOP and byte
counts of the model and of each hand-written kernel family, and the Zipf
sampler that draws the traffic's token ids.  Nothing here imports the
program; a later change to the program cannot move these numbers."""
