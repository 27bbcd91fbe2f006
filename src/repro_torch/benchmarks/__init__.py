"""The paper's experiment benchmarks on the port (`benchmarks/` of the JAX
package): `common` builds the grid's setups and sweeps an algorithm
through the host-sim API, `fig1_iid` prints Fig. 1's CSV."""
