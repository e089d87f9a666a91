"""One module a kind of traffic: it generates a cell's inputs from the seed
and drives the program through the measured window."""
