"""Plain references of the applications, one module per ``app`` that a
configuration names, each with the inputs both sides take.  They import
torch alone: nothing of the program, and nothing it made."""
