"""The synthetic token pipeline training reads (the port of the JAX
package's ``repro.data``)."""
