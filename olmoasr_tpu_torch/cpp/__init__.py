"""The port's native C++ cores (the BPE tokenizer), built by ``build.py`` at
first use."""
