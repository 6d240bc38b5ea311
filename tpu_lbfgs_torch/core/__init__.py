"""The solver loop and the search direction."""
