"""The AIRs' constraints, written out again for the reference: one module
an AIR, found by the name a configuration gives (`"air"`). Each module
gives WIDTH, NUM_PUBLIC, DEGREE (the largest constraint degree, selectors
counted as the prover's symbolic rules count them) and
`constraints(local, nxt, pis, sel)`, which yields every constraint's
values in the order the AIR asserts them."""
