create or replace temp view crv as
select d_date_sk cr_returned_date_sk,
       t_time_sk cr_returned_time_sk,
       i_item_sk cr_item_sk,
       rc.c_customer_sk cr_refunded_customer_sk,
       rc.c_current_cdemo_sk cr_refunded_cdemo_sk,
       rc.c_current_hdemo_sk cr_refunded_hdemo_sk,
       rc.c_current_addr_sk cr_refunded_addr_sk,
       tc.c_customer_sk cr_returning_customer_sk,
       tc.c_current_cdemo_sk cr_returning_cdemo_sk,
       tc.c_current_hdemo_sk cr_returning_hdemo_sk,
       tc.c_current_addr_sk cr_returning_addr_sk,
       cc_call_center_sk cr_call_center_sk,
       cp_catalog_page_sk cr_catalog_page_sk,
       sm_ship_mode_sk cr_ship_mode_sk,
       w_warehouse_sk cr_warehouse_sk,
       r_reason_sk cr_reason_sk,
       cret_order_id cr_order_number,
       cret_return_qty cr_return_quantity,
       cret_return_amt cr_return_amount,
       cret_return_tax cr_return_tax,
       cret_return_amt + cret_return_tax cr_return_amt_inc_tax,
       cret_return_fee cr_fee,
       cret_return_ship_cost cr_return_ship_cost,
       cret_refunded_cash cr_refunded_cash,
       cret_reversed_charge cr_reversed_charge,
       cret_merchant_credit cr_store_credit,
       cret_return_fee + cret_return_ship_cost + cret_return_tax cr_net_loss
from s_catalog_returns
     join item on cret_item_id = i_item_id
     join date_dim on cast(cret_return_date as date) = d_date
     left join customer rc on cret_refund_customer_id = rc.c_customer_id
     left join customer tc on cret_return_customer_id = tc.c_customer_id
     left join call_center on cret_call_center_id = cc_call_center_id
     left join catalog_page on cret_catalog_page_id = cp_catalog_page_id
     left join ship_mode on cret_shipmode_id = sm_ship_mode_id
     left join warehouse on cret_warehouse_id = w_warehouse_id
     left join reason on cret_reason_id = r_reason_id
     left join time_dim on t_time = 43200;

insert into catalog_returns
select cr_returned_date_sk, cr_returned_time_sk, cr_item_sk,
       cr_refunded_customer_sk, cr_refunded_cdemo_sk, cr_refunded_hdemo_sk,
       cr_refunded_addr_sk, cr_returning_customer_sk, cr_returning_cdemo_sk,
       cr_returning_hdemo_sk, cr_returning_addr_sk, cr_call_center_sk,
       cr_catalog_page_sk, cr_ship_mode_sk, cr_warehouse_sk, cr_reason_sk,
       cr_order_number, cr_return_quantity, cr_return_amount, cr_return_tax,
       cr_return_amt_inc_tax, cr_fee, cr_return_ship_cost, cr_refunded_cash,
       cr_reversed_charge, cr_store_credit, cr_net_loss
from crv;
