"""The generators: one per ``kind`` of traffic file, each driving one entry
of the program from the parameters of the traffic file alone."""
